#!/usr/bin/env python3
"""Time design variants of the bf16 (and f16) flash forward kernel on one
card, in turns with the parent commit's build and with SDPA.

    python3 tools/torch_flash_fwd_variants.py [--parent DIR] [--parent-rev REV]
                                              [--extra NAME=FILE ...]

Builds, side by side with nvcc under ``build/flash_fwd_variants/``:

  parent        the parent commit's ``flash_attention_fwd.cu`` with its own
                ``hopper_sm90.cuh``, read from ``--parent`` (default
                ``build/flash_parent/``; where that directory is missing it
                is filled from git, ``git show REV:paddle_tpu_torch/csrc/...``
                with ``--parent-rev``, default HEAD~1), with an info entry
                appended where it has none (`_PARENT_FWD_INFO`);
  source        ``paddle_tpu_torch/csrc/flash_attention_fwd.cu`` as it is;
  keys64        the D = 128 kernel with 64-key K/V tiles in a 4-stage ring;
  no_pingpong   the two consumer warpgroups without turns at the tensor
                cores (no named barriers);
  grid          one CTA a work item instead of one CTA an SM;
  probe_noload  timing only, not checked (its output is wrong by design):
                the producer arrives on each K/V full barrier without a
                copy, so the consumers read whatever shared memory holds;
  probe_nosoftmax  timing only: the softmax does nothing;
  NAME          with ``--extra NAME=FILE`` (repeatable): another version of
                the source, an earlier state of the file say.

It prints what ptxas says of every wgmma kernel (registers, spills,
serialized wgmma, setmaxnreg warnings), then what each library's info
entry says of its D = 64 and D = 128 kernels (CTAs an SM at the launch's
shared memory, registers and local bytes a thread). Each library is first
checked in a child process with a time limit (a kernel that deadlocks is
reported and left out, not waited for): the forward against its fp32 twin
with `chip_smoke.py`'s criteria at D = 128 over the 128-row tiles' edges,
f16 too, and two launches bit for bit equal. Then the libraries are timed
in turns (each, then in reverse) with SDPA beside each, at (4, 2048, 16,
128) causal and at each D = 64 main-path shape (`TIMED`). The card's name and power limit
come first. Needs a Hopper card, nvcc and the repository's root as the
working directory.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from paddle_tpu_torch.kernels import _build  # noqa: E402
from paddle_tpu_torch.kernels import flash_attention as fa  # noqa: E402

CSRC = ROOT / "paddle_tpu_torch" / "csrc"
OUT = ROOT / "build" / "flash_fwd_variants"
PARENT = ROOT / "build" / "flash_parent"
PARENT_FILES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu",
                "hopper_sm90.cuh")
GPT3 = (4, 2048, 16, 128)
GPT2 = (8, 1024, 12, 64)
CHECK_SECONDS = 300

# an info entry for the parent's kernels (its sources have none): the same
# interface as the source's `paddle_flash_attention_fwd_info`
_INFO_HELPER = """
template <typename Kernel>
static cudaError_t variant_kernel_info(Kernel* kernel, int threads, int smem,
                                       int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(attr.localSizeBytes);
  out[3] = smem;
  out[4] = threads;
  return err;
}
"""
_PARENT_FWD_INFO = _INFO_HELPER + """
template <typename T, int D, bool C>
static int parent_fwd_info(int* out) {
  return static_cast<int>(variant_kernel_info(
      flash_fwd_kernel_wgmma<T, D, C>, kWgmmaThreads,
      static_cast<int>(sizeof(FwdSmem<D>)) + 1024, out));
}

extern "C" int paddle_flash_attention_fwd_info(int head_dim, int dtype,
                                               int causal, int* out) {
  if (dtype == 1) {
    if (head_dim == 64) {
      return causal ? parent_fwd_info<__nv_bfloat16, 64, true>(out)
                    : parent_fwd_info<__nv_bfloat16, 64, false>(out);
    }
    return causal ? parent_fwd_info<__nv_bfloat16, 128, true>(out)
                  : parent_fwd_info<__nv_bfloat16, 128, false>(out);
  }
  if (head_dim == 64) {
    return causal ? parent_fwd_info<__half, 64, true>(out)
                  : parent_fwd_info<__half, 64, false>(out);
  }
  return causal ? parent_fwd_info<__half, 128, true>(out)
                : parent_fwd_info<__half, 128, false>(out);
}
"""


def parent_dir(path, rev):
    """The directory that holds the parent's sources (PARENT_FILES): `path`
    as it is, or filled from git at `rev` where it is missing."""
    path = Path(path)
    if all((path / f).exists() for f in PARENT_FILES):
        return path
    path.mkdir(parents=True, exist_ok=True)
    for name in PARENT_FILES:
        text = subprocess.run(
            ["git", "show", f"{rev}:paddle_tpu_torch/csrc/{name}"],
            cwd=ROOT, capture_output=True, text=True, check=True).stdout
        (path / name).write_text(text)
    return path


def _sub_const(src, name, value):
    """`src` with the constant `name` set to `value`."""
    out, count = re.subn(rf"(constexpr \w+ {name} = )[^;]+;",
                         rf"\g<1>{value};", src)
    assert count == 1, (name, count)
    return out


# probes, timed but not checked (their outputs are wrong by design): the
# producer arrives on each K/V full barrier without a copy
# (`probe_noload`), or the softmax does nothing (`probe_nosoftmax`)
_LOAD = """        mbar_expect_tx(&full[s], kKvBytes);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
#pragma unroll
          for (int r = 0; r < kN / kRows; ++r) {
            tma_load(&dst[s][p][r * kRows * kPanel], map, &full[s],
                     p * kPanel, it.h, j * kN + r * kRows, it.b);
          }
        }"""
_SOFTMAX = re.compile(r"(    auto softmax = \[&\]\(int j, float \(&alpha\)\[2\]\) "
                      r"\{\n).*?(\n    \};\n)", re.S)


def _d128(src, *pairs):
    """`src` with each (old, new) text replaced once in the D = 128
    kernel (after its definition)."""
    at = src.index("flash_fwd_kernel_wgmma_d128(const")
    head, body = src[:at], src[at:]
    for old, new in pairs:
        assert body.count(old) == 1, old
        body = body.replace(old, new)
    return head + body


def variants(parent, extra=()):
    """name -> (source text, include directory); `extra`: (name, path)
    pairs of other versions of the source to build beside them."""
    src = (CSRC / "flash_attention_fwd.cu").read_text()
    text = (parent / "flash_attention_fwd.cu").read_text()
    if "paddle_flash_attention_fwd_info" not in text:
        text += _PARENT_FWD_INFO
    out = {"parent": (text, parent), "source": (src, CSRC)}
    keys64 = _sub_const(src, "kFwd128Keys", "64")
    out["keys64"] = (_sub_const(keys64, "kFwd128Stages", "4"), CSRC)
    out["no_pingpong"] = (_sub_const(src, "kFwd128PingPong", "false"), CSRC)
    out["grid"] = (_sub_const(src, "kFwd128Persistent", "false"), CSRC)
    out["probe_noload"] = (_d128(src, (_LOAD, "        mbar_arrive(&full[s]);")),
                           CSRC)
    at = src.index("flash_fwd_kernel_wgmma_d128(const")
    body, count = _SOFTMAX.subn(
        lambda mt: mt.group(1) + "      alpha[0] = alpha[1] = 1.f;"
        + mt.group(2), src[at:])
    assert count == 1, count
    out["probe_nosoftmax"] = (src[:at] + body, CSRC)
    for name, path in extra:
        out[name] = (Path(path).read_text(), CSRC)
    return out


def build(sources, out_dir, kernel_re):
    """Compile every variant at once (name -> (text, include dir)) into
    `out_dir`, printing ptxas's registers, spills and warnings for the
    kernels whose mangled names match `kernel_re` (its first group names
    the kernel). Returns name -> library path; a variant that fails to
    build is reported and left out."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, include) in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build._FLAGS, "-Xptxas=-v", f"-I{include}",
               "-o", str(out_dir / f"lib{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"build {name}: nvcc failed, left out\n{log[-4000:]}",
                  flush=True)
            continue
        kernel = None
        for line in log.splitlines():
            found = re.search(kernel_re, line)
            if found and "Compiling entry" in line:
                kernel = found.group(1)
            elif "warning" in line.lower() or "serialized" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
            elif kernel and ("registers" in line or "spill" in line):
                print(f"ptxas {name}: {demangle(kernel)}: "
                      f"{line.split(':', 1)[-1].strip()}", flush=True)
                if "registers" in line:
                    kernel = None
        libs[name] = out_dir / f"lib{name}.so"
    return libs


def demangle(name):
    """A wgmma kernel's mangled name, shortened: its name and template
    arguments (type, then the integers and bools)."""
    kind = re.search(r"(flash_\w+?_wgmma(?:_d128)?)I", name)
    typ = "half" if "6__half" in name else "bf16"
    args = re.findall(r"L[ib](\d+)E", name)
    return f"{kind.group(1) if kind else name} {typ} {','.join(args)}"


def print_info(name, lib, entry, cases):
    """What the library's info entry `entry` says of each kernel in
    `cases` (tuples of its integer arguments before `out`)."""
    fn = getattr(lib, entry)
    for args in cases:
        out = (ctypes.c_int * 5)()
        err = fn(*[ctypes.c_int(a) for a in args], out)
        print(f"info {name} {entry}{args}: err {err}, CTAs an SM {out[0]}, "
              f"registers {out[1]}, local bytes {out[2]}, smem {out[3]}, "
              f"threads {out[4]}", flush=True)


def run_checks(names, timeout=CHECK_SECONDS, script=__file__):
    """Each library's checks in a child process (`script` --check NAME)
    under a time limit; returns the names that passed."""
    passed = []
    for name in names:
        try:
            proc = subprocess.run([sys.executable, script, "--check", name],
                                  cwd=ROOT, capture_output=True, text=True,
                                  timeout=timeout)
        except subprocess.TimeoutExpired as exc:
            out = (exc.stdout or b"")
            out = out.decode() if isinstance(out, bytes) else out
            print(f"check {name}: no end within {timeout} s (a deadlock?), "
                  f"left out\n{out[-3000:]}", flush=True)
            continue
        tail = "\n".join(proc.stdout.splitlines()[-60:])
        print(f"check {name}: exit {proc.returncode}\n{tail}"
              + (f"\n{proc.stderr[-3000:]}" if proc.returncode else ""),
              flush=True)
        if proc.returncode == 0:
            passed.append(name)
    return passed


def check(name):
    """The forward of library `name` against its fp32 twin at D = 128 over
    the 128-row tiles' edges (chip_smoke.py's criteria), f16 too, and
    twice bit for bit at config 3's shape."""
    _build._LIBS["flash_attention_fwd"] = ctypes.CDLL(
        str(OUT / f"lib{name}.so"))
    d = 128
    for n in (40, 65, 129, 200, 2047):
        for causal in (True, False):
            cs._check_flash_case(f"{name} n={n} causal={causal} D=128",
                                 *cs._fused_qkv(n, torch.bfloat16,
                                                seed=400 + n, heads=4,
                                                head_dim=d), causal)
    q = cs._fused_qkv(40, torch.bfloat16, seed=41, heads=4, head_dim=d)[0]
    _, k, v = cs._fused_qkv(300, torch.bfloat16, seed=42, heads=4,
                            head_dim=d)
    cs._check_flash_case(f"{name} n=40 m=300 causal=False D=128", q, k, v,
                         False)
    cs._check_flash_case(f"{name} (3, 200, 4, 128) causal=True",
                         *cs._fused_qkv(200, torch.bfloat16, seed=43,
                                        heads=4, head_dim=d, batch=3), True)
    for causal in (True, False):
        cs._check_flash_case(f"{name} (8, 1000, 16, 128) causal={causal}",
                             *cs._fused_qkv(1000, torch.bfloat16, seed=45,
                                            heads=16, head_dim=d, batch=8),
                             causal)
    q = cs._fused_qkv(40, torch.bfloat16, seed=46, heads=32, head_dim=d,
                      batch=8)[0]
    _, k, v = cs._fused_qkv(300, torch.bfloat16, seed=47, heads=32,
                            head_dim=d, batch=8)
    cs._check_flash_case(f"{name} (8, 40, 32, 128) m=300 causal=False", q, k,
                         v, False)
    for n in (65, 200):
        cs._check_flash_case(f"{name} float16 n={n} causal=True D=128",
                             *cs._fused_qkv(n, torch.float16, seed=44 + n,
                                            heads=4, head_dim=d), True)
    b, n, h, d = GPT3
    qkv = cs._fused_qkv(n, torch.bfloat16, seed=2048, heads=h, head_dim=d,
                        batch=b)
    cs._check_flash_case(f"{name} {GPT3} causal=True", *qkv, True)
    cs._twice_equal(f"{name} {GPT3}", lambda: fa.flash_attention_fwd(
        *qkv, True))


# the in-turns timings: (shape, causal, dtype). Config 3's shape, then
# every main-path shape of the D = 64 kernel (GPT-2 training, the serving
# prefill bucket, ViT-L/16, f16 training), whose code the variants share
TIMED = ((GPT3, True, torch.bfloat16), (GPT2, True, torch.bfloat16),
         ((1, 1024, 12, 64), True, torch.bfloat16),
         ((32, 197, 16, 64), False, torch.bfloat16),
         (GPT2, True, torch.float16), (GPT3, True, torch.float16))


def time_turns(libs, timed=TIMED):
    """Every library's forward at each case of `timed`, in turns (each,
    then in reverse), SDPA beside each."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape, causal, dtype in timed:
        b, n, h, d = shape
        q, k, v = cs._fused_qkv(n, dtype, seed=n, heads=h, head_dim=d,
                                batch=b)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pairs = n * (n + 1) // 2 if causal else n * n
        flops = 4 * b * h * d * pairs
        bound = cs._bound_ms(b * (4 * n * h * d * 2 + h * n * 4), flops,
                             dtype)
        for name in list(libs) + list(libs)[::-1]:
            _build._LIBS["flash_attention_fwd"] = libs[name]
            ms = cs._timed(lambda: fa.flash_attention_fwd(q, k, v, causal),
                           iters=50)[0]
            with torch.no_grad():
                lib_ms = cs._timed(lambda: sdpa(qt, kt, vt,
                                                is_causal=causal),
                                   iters=50)[0]
            print(f"time {name} {shape} {str(dtype)[6:]} causal={causal}: "
                  f"fwd {ms:.5f} ms ({flops / (ms * 1e-3) / 1e12:.1f} "
                  f"TFLOP/s, {bound[0] / ms:.3f} of the {bound[0]:.5f} ms "
                  f"bound); SDPA {lib_ms:.5f} ms: {ms / lib_ms:.3f}x",
                  flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", default=str(PARENT))
    parser.add_argument("--parent-rev", default="HEAD~1")
    parser.add_argument("--check")
    parser.add_argument("--extra", action="append", default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if args.check:
        check(args.check)
        return
    print(f"card: {cs._card()}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    parent = parent_dir(args.parent, args.parent_rev)
    extra = [item.split("=", 1) for item in args.extra]
    paths = build(variants(parent, extra), OUT,
                  r"(_Z\w*flash_fwd_kernel_wgmma\w*)")
    libs = {}
    for name, path in paths.items():
        libs[name] = ctypes.CDLL(str(path))
        print_info(name, libs[name], "paddle_flash_attention_fwd_info",
                   [(dd, t, c) for dd in (64, 128) for t in (1, 2)
                    for c in (1, 0)])
    passed = run_checks([k for k in libs if not k.startswith("probe_")])
    time_turns({k: libs[k] for k in libs
                if k in passed or k.startswith("probe_")})
    _build._LIBS.pop("flash_attention_fwd", None)


if __name__ == "__main__":
    main()
