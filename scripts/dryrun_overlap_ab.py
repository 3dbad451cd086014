#!/usr/bin/env python3
"""Whether the dry run's processes beside a host-bound path slow it.

    python3 scripts/dryrun_overlap_ab.py

Builds the kernels and makes ``chip_smoke.py``'s Hurricane snapshot, then
runs its Lorenzo path (LORENZO_EPOCHS epochs: the conventional stage on the
host, then training and decode on the card) four times in turns: alone;
beside the dry-run processes of ``chip_smoke.start_dryrun`` (started just
before, as ``chip_smoke.py`` starts them), twice; and alone again once they
have been ended.  Prints one JSON line: each run's compress and path
seconds and the dry-run cells still lowering when it ended (the decode and
enhancer cells take seconds, the train and prefill cells minutes).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("dryrun_overlap_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as smoke
    from repro_torch import device as device_lib
    from repro_torch.data import fields as fields_lib
    from repro_torch.kernels import _build

    dev = device_lib.resolve("cuda")
    _build.build()
    fields = fields_lib.make_fields("hurricane", (100, 500, 500), seed=0)

    def run(label):
        report: dict = {}
        t0 = time.perf_counter()
        smoke.lorenzo_path(dev, fields, smoke.LORENZO_EPOCHS, report)
        return {"run": label, "path_s": time.perf_counter() - t0,
                "compress_s": report["lorenzo_path"]["compress_s"],
                "dryrun_running": [f"{arch} {shape}" for (arch, shape), p, _
                                   in procs if p.poll() is None]}

    procs: list = []
    runs = [run("alone")]
    procs = smoke.start_dryrun()
    try:
        runs += [run("beside"), run("beside")]
    finally:
        smoke.stop_dryrun(procs)
    procs = []
    runs.append(run("alone"))
    print(json.dumps({"card": smoke.nvidia_smi_line(), "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
