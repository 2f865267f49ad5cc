"""The production-mesh dry run's CLI.

The counterpart of the JAX package's ``launch/dryrun.py`` (the same flags,
``--all``'s report of every failure at the end, and the ``--json-out``
contract), plus ``--hw``: the meshes are the hardware's (``h100``: mesh
``single`` the 1 x 8 NVLink node, ``multi`` two of them; ``tpu-v5e``: the
16 x 16 and 2 x 16 x 16 pods).  Where the reference forces 512 host
devices and compiles, this runs one rank's step on the meta device
(``launch/dryrun_impl.py``): no device, no process group, nothing
allocated; ``--devices`` names the ranks the mesh must have.

    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --mesh multi --json-out build/dryrun_multi.json
    python -m repro_torch.launch.dryrun --arch X --shape Y --plan-json '{"remat": "full"}'
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id (see repro_torch.configs.ARCH_IDS)")
    ap.add_argument("--shape", help="input shape id (train_4k/prefill_32k/decode_32k/long_500k)")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true", help="run every (arch x shape) cell")
    ap.add_argument("--plan-json", default=None, help="SchedulePlan overrides as JSON")
    ap.add_argument("--json-out", default=None, help="write record(s) to this JSON file")
    ap.add_argument("--devices", type=int, default=None,
                    help="the mesh's rank count (a check: the dry run runs one rank)")
    ap.add_argument("--hw", default="h100", choices=["h100", "tpu-v5e"])
    args = ap.parse_args(argv)

    from repro_torch.configs import cells, get_config, get_shape
    from repro_torch.core.hardware import get_hardware
    from repro_torch.core.space import SchedulePlan, get_mesh
    from repro_torch.launch.dryrun_impl import evaluate_cell
    from repro_torch.launch.measure import default_plan

    spec = get_hardware(args.hw)
    mspec = get_mesh(spec, args.mesh)
    if args.devices is not None and args.devices != mspec.size:
        print(f"[dryrun] mesh {args.mesh} on {args.hw} has {mspec.size} ranks, not {args.devices}",
              file=sys.stderr)
        return 2
    if args.all:
        todo = [(c.name, s.name) for c, s in cells()]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all required"
        todo = [(args.arch, args.shape)]
    records, failures = [], []
    for arch, shape in todo:
        try:
            plan = None
            if args.plan_json:
                d = default_plan(get_config(arch), get_shape(shape), mspec, spec).to_dict()
                d.update(json.loads(args.plan_json))
                plan = SchedulePlan.from_dict(d)
            records.append(evaluate_cell(arch, shape, args.mesh, plan, hw=args.hw))
        except Exception as e:  # noqa: BLE001 - report all failures at the end
            traceback.print_exc()
            failures.append((arch, shape, repr(e)))
    if args.json_out:
        out = records[0] if (not args.all and records) else records
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    if failures:
        print(f"[dryrun] {len(failures)} FAILURES:")
        for a, s, e in failures:
            print(f"  {a} x {s}: {e}")
        return 1
    print(f"[dryrun] all {len(records)} cell(s) counted on mesh={args.mesh} ({args.hw})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
