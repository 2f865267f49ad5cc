"""Tuner-as-a-service CLI of the port: daemon and client ends of one
Unix socket.

Serve (long-lived; one worker pool + one fleet + one plan store for every
request it ever answers):

    python -m repro_torch.launch.tune_serve serve --store STORE_DIR \
        --socket tuner.sock --parallel
    python -m repro_torch.launch.tune_serve serve --store STORE_DIR \
        --socket tuner.sock --measure real --device cuda --measure-layers 6

Client (per request; returns the tuned plan as JSON on stdout):

    python -m repro_torch.launch.tune_serve tune --socket tuner.sock \
        --arch granite-3-2b --shape train_4k --algo mcts_1s --hw h100
    python -m repro_torch.launch.tune_serve stats --socket tuner.sock
    python -m repro_torch.launch.tune_serve shutdown --socket tuner.sock

The JAX CLI's flags, plus the daemon's ``--device`` (where learned cost
models, ``pricing="jit"`` and card measurements run), ``--measure-layers``
and ``--measure-cache`` (the cut and the record cache of ``--measure
real``), and a request's ``--hw`` and ``--mesh card``.
"""
from __future__ import annotations

import argparse
import json
import socket


class TuneClient:
    """One JSON-lines request/response per call over the daemon socket."""

    def __init__(self, socket_path: str, timeout: float = 600.0):
        self.socket_path = socket_path
        self.timeout = timeout

    def call(self, msg: dict) -> dict:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(self.timeout)
            s.connect(self.socket_path)
            with s.makefile("rwb") as f:
                f.write((json.dumps(msg) + "\n").encode())
                f.flush()
                line = f.readline()
        if not line:
            raise ConnectionError("daemon closed the connection")
        return json.loads(line)

    def tune(self, arch: str, shape: str, **settings) -> dict:
        return self.call({"op": "tune", "arch": arch, "shape": shape,
                          **settings})

    def stats(self) -> dict:
        return self.call({"op": "stats"})

    def ping(self) -> dict:
        return self.call({"op": "ping"})

    def shutdown(self) -> dict:
        return self.call({"op": "shutdown"})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    sv = sub.add_parser("serve", help="run the daemon")
    sv.add_argument("--store", required=True, help="plan-store root dir")
    sv.add_argument("--socket", required=True, help="unix socket path")
    sv.add_argument("--parallel", action="store_true",
                    help="share one pinned worker pool across runs")
    sv.add_argument("--workers", type=int, default=None)
    sv.add_argument("--measure", default="none",
                    choices=["none", "stub", "real"],
                    help="shared measurement fleet for *real* algos "
                         "(real = steps timed on --device; stub = the "
                         "deterministic analytic target)")
    sv.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where learned cost models, pricing=jit and "
                         "--measure real run")
    sv.add_argument("--measure-layers", type=int, default=None,
                    help="--measure real: cut the depth to this many layers")
    sv.add_argument("--measure-cache", default=None,
                    help="the fleet's record cache (default: STORE/measure_cache)")
    sv.add_argument("--max-requests", type=int, default=None,
                    help="exit after N tune requests (tests/CI smoke)")
    sv.add_argument("--read-timeout", type=float, default=30.0,
                    help="per-connection socket read timeout in seconds "
                         "(a silent client is closed, not waited on)")
    sv.add_argument("--queue-size", type=int, default=16,
                    help="bounded tune-request queue; a full queue answers "
                         "'overloaded' with a retry_after_s hint")
    sv.add_argument("--checkpoint-every", type=int, default=4,
                    help="persist a resumable search checkpoint every K "
                         "decision rounds (0 disables crash resume)")
    sv.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request search deadline; requests "
                         "override with their own deadline_s")
    sv.add_argument("--degrade-after", type=int, default=5,
                    help="cumulative pool worker restarts before the "
                         "watchdog degrades to the sequential engine")
    sv.add_argument("--round-delay", type=float, default=0.0,
                    help=argparse.SUPPRESS)  # fault-injection: slow rounds
    sv.add_argument("--no-recover", action="store_true",
                    help="skip write-ahead-journal replay on startup")

    def add_request_args(p):
        p.add_argument("--socket", required=True)
        p.add_argument("--arch", required=True)
        p.add_argument("--shape", required=True)
        p.add_argument("--algo", default="mcts_30s")
        p.add_argument("--mesh", default="single", choices=["single", "multi", "card"])
        p.add_argument("--hw", default="h100", choices=["h100", "tpu-v5e"])
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--budget-s", type=float, default=None)
        p.add_argument("--n-standard", type=int, default=15)
        p.add_argument("--n-greedy", type=int, default=1)
        p.add_argument("--noise-sigma", type=float, default=0.0)
        p.add_argument("--cost", default="analytic",
                       choices=["analytic", "learned", "hybrid"])
        p.add_argument("--pricing", default=None, choices=["scalar", "columnar", "jit"])
        p.add_argument("--deadline-s", type=float, default=None,
                       help="interrupt the search at the next round "
                            "boundary after this many seconds; the "
                            "response is best-so-far with interrupted "
                            "provenance, and a repeat request resumes "
                            "from the checkpoint")

    tn = sub.add_parser("tune", help="submit one tuning request")
    add_request_args(tn)

    st = sub.add_parser("stats", help="daemon counters")
    st.add_argument("--socket", required=True)
    sd = sub.add_parser("shutdown", help="stop the daemon")
    sd.add_argument("--socket", required=True)

    args = ap.parse_args(argv)

    if args.cmd == "serve":
        from repro_torch.service.daemon import TunerService, serve_forever

        fleet_kwargs = {"cache_dir": args.measure_cache} if args.measure_cache else None
        service = TunerService(
            args.store, parallel=args.parallel, n_workers=args.workers,
            measure=args.measure, fleet_kwargs=fleet_kwargs,
            device=args.device,
            cut={"layers": args.measure_layers} if args.measure_layers else None,
            checkpoint_every=args.checkpoint_every,
            deadline_s=args.deadline_s,
            round_delay_s=args.round_delay,
            degrade_after=args.degrade_after,
        )
        served = serve_forever(service, args.socket,
                               max_requests=args.max_requests,
                               read_timeout_s=args.read_timeout,
                               queue_size=args.queue_size,
                               recover=not args.no_recover)
        print(f"[tune_serve] served {served} request(s)")
        return 0

    client = TuneClient(args.socket)
    if args.cmd == "stats":
        out = client.stats()
    elif args.cmd == "shutdown":
        out = client.shutdown()
    else:
        settings = dict(
            algo=args.algo, mesh=args.mesh,
            seed=args.seed, time_budget_s=args.budget_s,
            n_standard=args.n_standard, n_greedy=args.n_greedy,
            noise_sigma=args.noise_sigma, cost=args.cost, hw=args.hw,
        )
        if args.pricing is not None:
            settings["pricing"] = args.pricing
        if args.deadline_s is not None:
            settings["deadline_s"] = args.deadline_s
        out = client.tune(args.arch, args.shape, **settings)
    print(json.dumps(out, indent=1, default=str))
    return 0 if out.get("ok") else 1


if __name__ == "__main__":
    raise SystemExit(main())
