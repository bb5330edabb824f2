"""Router entry point of the port: spread ``/generate`` across serving
workers (engine/router.py) — the port of the JAX package's
``neurons/router.py``, with its flags.

It polls each backend's ``/healthz``, routes every request to the
least-loaded backend on the majority base revision, routes it as two legs
(``/prefill`` on a prefill worker, ``/generate`` on a decode worker) when
both classes are up, and sheds with ``429`` + ``Retry-After`` once every
backend sits at its admission bound. It holds no model and needs no card.
A prefill/decode pair and a unified worker on one machine::

    python -m distributedtraining_tpu_torch.neurons.server --backend local \\
        --work-dir /tmp/run --dataset synthetic --tokenizer word \\
        --serve-phase prefill --serve-port 8901 &
    python -m distributedtraining_tpu_torch.neurons.server --backend local \\
        --work-dir /tmp/run --dataset synthetic --tokenizer word \\
        --serve-phase decode --serve-port 8902 &
    python -m distributedtraining_tpu_torch.neurons.router --port 8800 \\
        --backend http://127.0.0.1:8901 --backend http://127.0.0.1:8902

    curl -d '{"tokens": [1, 2, 3]}' http://127.0.0.1:8800/generate

It routes until interrupted, or until its frontend is closed (an
embedding caller's stop).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from ..engine.router import RouterHTTPFrontend, RouterPolicy

logger = logging.getLogger(__name__)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", action="append", dest="backends",
                    required=True,
                    help="serving backend base URL (repeatable), e.g. "
                         "http://10.0.0.1:8900")
    ap.add_argument("--port", type=int, default=8800)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-queue", type=int, default=6,
                    help="per-backend admission bound (queued + active) "
                         "before the router sheds with 429")
    ap.add_argument("--shed-ttft-ms", type=float, default=0.0,
                    help="also shed a backend whose observed ttft p95 "
                         "exceeds this (0 = queue-bound only)")
    ap.add_argument("--no-prefer-revision", dest="prefer_revision",
                    action="store_false",
                    help="do not prefer backends on the majority base "
                         "revision")
    ap.add_argument("--poll-interval", type=float, default=1.0,
                    help="seconds between /healthz sweeps")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="per-request backend timeout (seconds)")
    ap.add_argument("--retry-after-cap", type=float, default=0.25,
                    help="max seconds to honor a backend's Retry-After "
                         "hint before retrying the next-best backend "
                         "(0 disables the wait)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)
    from ..parallel import multihost
    multihost.refuse_world("router")

    logging.basicConfig(level=logging.INFO if args.verbose
                        else logging.WARNING)
    policy = RouterPolicy(max_queue_depth=args.max_queue,
                          shed_ttft_ms=args.shed_ttft_ms,
                          prefer_revision=args.prefer_revision)
    fe = RouterHTTPFrontend(args.backends, args.port, host=args.host,
                            policy=policy,
                            poll_interval_s=args.poll_interval,
                            timeout_s=args.timeout,
                            retry_after_cap_s=args.retry_after_cap)
    port = fe.start()
    print(f"router: http://{args.host}:{port}/generate -> "
          f"{len(args.backends)} backends (max queue {args.max_queue})",
          file=sys.stderr)
    try:
        while fe.running:
            time.sleep(0.1)
    except KeyboardInterrupt:
        pass
    finally:
        fe.close()
    logger.info("router done: routed=%d disaggregated=%d fallbacks=%d "
                "shed=%d", fe.routed, fe.disagg_routed, fe.disagg_fallbacks,
                fe.shed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
