"""Drop-in CLI for ``repro_torch.launch.measure`` that never touches a card:
the same flags and ``--json-out`` contract, but the record comes from the
analytic stub (``repro_torch.core.measure_stub``).  Tests point
``repro_torch.core.measure.DRYRUN_MODULE`` at this module to exercise the
real subprocess path (tmp-file handling, timeout, exit codes) without a
measurement.  The counterpart of the JAX package's ``launch/dryrun_stub.py``.

``REPRO_STUB_SLEEP_S`` (env) sleeps before writing the record, so a test
can force ``subprocess.TimeoutExpired`` deterministically.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "card"])
    ap.add_argument("--hw", default="h100")
    ap.add_argument("--plan-json", default=None)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--devices", type=int, default=None)
    args = ap.parse_args(argv)

    sleep_s = float(os.environ.get("REPRO_STUB_SLEEP_S", "0"))
    if sleep_s:
        time.sleep(sleep_s)

    from repro_torch.core.measure_stub import stub_measure

    rec = stub_measure(
        {
            "arch": args.arch,
            "shape": args.shape,
            "mesh": args.mesh,
            "plan": json.loads(args.plan_json) if args.plan_json else None,
            "devices": args.devices,
            "hw": args.hw,
        }
    )
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
    else:
        json.dump(rec, sys.stdout, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
