"""Run the training-remainder and deployment phases of `chip_smoke.py`
alone on the card:

    python3 tools/torch_train_phases.py [phase ...]

phases: train_amp, train_optimizers, train_scaler, train_guard,
train_resume, train_fp16, export, predictor, async_save, vit, resnet,
vision_data, gpt3_dp (all of them, in that order, by default; vit first
checks and
times the flash pair at ViT-L/16's shape, `check_flash_vit`; gpt3_dp the
flash kernels and the AdamW update at config 3's shapes,
`check_flash_gpt3` and `check_adam_gpt3`). Builds the kernels, then runs each phase as
`chip_smoke.py` does (train_optimizers first checks the AdamW update
kernel against its twin: its time is the phase's yardstick), each
followed by the smoke's memory line, and prints its wall time (~100 s of
command time for the first four on an H100). A fresh process, so
the profiler counts every kernel of the updates, which late in a full
`chip_smoke.py` run it may not.
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main():
    print(cs._card())
    t0 = time.perf_counter()
    secs, _ = cs._build.build_all()
    print(f"build {secs:.1f} s")
    phases = {"train_amp": cs.train_amp,
              "train_optimizers": lambda: cs.train_optimizers(
                  cs.check_adam_update()[0]["ms"]),
              "train_scaler": cs.train_scaler,
              "train_guard": cs.train_guard,
              "train_resume": cs.train_resume,
              "train_fp16": cs.train_fp16,
              "export": cs.export_phase,
              "predictor": cs.predictor_phase,
              "async_save": cs.async_save_phase,
              "vit": lambda: (cs.check_flash_vit(), cs.vit_phase()),
              "resnet": cs.resnet_phase,
              "vision_data": cs.vision_data_phase,
              "gpt3_dp": lambda: (cs.check_flash_gpt3(),
                                  cs.check_adam_gpt3(),
                                  cs.gpt3_dp_phase())}
    for name in sys.argv[1:] or list(phases):
        t = time.perf_counter()
        phases[name]()
        cs._phase_memory(name)
        print(f"{name}: {time.perf_counter() - t:.1f} s", flush=True)
    print(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
