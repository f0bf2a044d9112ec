"""The port stands alone: importing every module of paddle_tpu_torch (and
chip_smoke.py's imports) loads neither `jax` nor any module of the JAX
package `paddle_tpu` — checked in a fresh interpreter, since this test
process has both loaded already."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import paddle_tpu_torch
names = ["paddle_tpu_torch"]
for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                  "paddle_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
import chip_smoke  # noqa: F401  (its import must not pull JAX in either)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "paddle_tpu" or m.startswith("paddle_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_paddle_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == [], res["bad"]
    expected = {"paddle_tpu_torch.serving.engine",
                "paddle_tpu_torch.kernels.flash_attention",
                "paddle_tpu_torch.kernels.paged_attention",
                "paddle_tpu_torch.kernels.cross_entropy",
                "paddle_tpu_torch.incubate.models.gpt",
                "paddle_tpu_torch.incubate.nn.functional",
                "paddle_tpu_torch.nn.functional.loss",
                "paddle_tpu_torch.nn.clip",
                "paddle_tpu_torch.framework.flags",
                "paddle_tpu_torch.optimizer.optimizer",
                "paddle_tpu_torch.optimizer.optimizers",
                "paddle_tpu_torch.optimizer.lr",
                "paddle_tpu_torch.kernels.adam_update",
                "paddle_tpu_torch.kernels.prefill_scatter",
                "paddle_tpu_torch.jit.train_step",
                "paddle_tpu_torch.convert",
                "paddle_tpu_torch.quantization.kv_cache",
                "paddle_tpu_torch.kernels.fused_ln",
                "paddle_tpu_torch.incubate.nn.fused_transformer",
                "paddle_tpu_torch.serving.tenancy",
                "paddle_tpu_torch.kernels.lora_delta",
                "paddle_tpu_torch.optimizer.regularizer",
                "paddle_tpu_torch.amp",
                "paddle_tpu_torch.amp.auto_cast",
                "paddle_tpu_torch.amp.grad_scaler",
                "paddle_tpu_torch.ops.guardian",
                "paddle_tpu_torch.ops.numerics",
                "paddle_tpu_torch.kernels.finite_check",
                "paddle_tpu_torch.framework.io",
                "paddle_tpu_torch.incubate.checkpoint"}
    assert expected <= set(res["imported"])
