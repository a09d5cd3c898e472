#!/usr/bin/env python3
"""The file path alone on one GPU: ``chip_smoke.py``'s phase 10 (the 132 s
MH_03 proxy in memory, fused, float32) and phase 12 (the same scene written
as an ASL tree and run through ``app.batch`` with a 5 s racing tree, the
run stopped at its checkpoint and resumed, a rosbag against an ASL tree),
with the KLT kernel built first; about 4 minutes on an H100.

    python scripts/files_card.py

Prints the card and its power limit, the phases' lines and, last, one JSON
line with each phase's seconds; exits nonzero if a check fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import chip_smoke as S
    import torch

    from eqvio_tpu_torch.data import mh03_proxy
    from eqvio_tpu_torch.io import mh03_proxy_config
    from eqvio_tpu_torch.kernels import klt as K
    from eqvio_tpu_torch.runtime import configure_runtime

    if not torch.cuda.is_available():
        S.fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    configure_runtime("cuda")
    build_s = K.build_kernel()
    t0 = time.perf_counter()
    mh03 = mh03_proxy(S.MH03_SECONDS)
    scene_s = time.perf_counter() - t0
    cfg = mh03_proxy_config()
    t0 = time.perf_counter()
    mh = S.phase_mh03(mh03, cfg, scene_s, card)
    memory_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    files = S.phase_files(mh03, cfg, mh, card)
    files_s = time.perf_counter() - t0
    print(json.dumps({"card": card, "build_s": build_s, "scene_s": scene_s, "phase10_s": memory_s,
                      "phase12_s": files_s, **files}), flush=True)


if __name__ == "__main__":
    main()
