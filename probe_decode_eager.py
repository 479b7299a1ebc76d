#!/usr/bin/env python3
"""Probe: the eager decode step of full-size hymba-1.5b from the
``repro_torch`` package under SRC, on one GPU.

    python3 probe_decode_eager.py SRC

SRC is a directory holding ``repro_torch`` (``src`` for this checkout, or
the ``src`` of another commit unpacked with ``git archive``).  Prefill of
4 prompts of 2048 tokens, then 8 teacher-forced decode steps, each
reading its token on the host; the steps are timed three times, then
once more after a ``torch.profiler`` session.  Two trees are compared in
one call, in turns (A, B, B, A): a process each, so that each loads its
own package.  Never on a path: the smoke's decode profile
(``chip_smoke.decode_profile``) times this checkout's captured and eager
steps.
"""
import sys
import time

if len(sys.argv) != 2:
    sys.exit(__doc__)
sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import make_model, make_prompts  # noqa: E402

cfg = get_config("hymba-1.5b")
model = make_model(cfg, device="cuda", seed=0)
prompts = torch.from_numpy(make_prompts(cfg, 4, 2048, 0)).cuda()
forced = torch.from_numpy(make_prompts(cfg, 4, 8, 1)).cuda()


def run() -> float:
    with torch.inference_mode():
        _, caches = model.prefill({"tokens": prompts}, 2048 + 32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(8):
            logits, caches = model.decode_step(forced[:, i:i + 1], caches,
                                               2048 + i)
            logits[:, -1].argmax(dim=-1).cpu()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / 8


times = [run() for _ in range(3)]
with profile(activities=[ProfilerActivity.CUDA]):
    run()
after = run()
print(f"{sys.argv[1]}: eager ms/step {times}, after a profiler session "
      f"{after}", flush=True)
