"""Start N render workers on this machine (a torchrun analog).

    python -m bpt_tpu_torch.parallel.launch -n 2 [--device cuda] [--backend gloo] -- \\
        --size 64x64 --spp 16 --output out.npy

Everything after ``--`` goes to every ``bpt_tpu_torch.parallel.worker``
(that module lists the render flags).  ``--device cpu`` runs the ranks on
the CPU over gloo; ``--device cuda`` puts rank i on card i % cards over
nccl, or, with ``--backend gloo``, lets several ranks share a card.  On a
cluster, skip this launcher and start one worker a host with a shared
``--coordinator``.
"""

from __future__ import annotations

import argparse
import sys

from bpt_tpu_torch.parallel.multiprocess import launch_local


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        split = argv.index("--")
        argv, worker_args = argv[:split], argv[split + 1:]
    else:
        worker_args = []
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)

    outs = launch_local(args.num_processes, worker_args, device=args.device,
                        backend=args.backend, timeout=args.timeout)
    for o in outs:
        sys.stdout.write(o)
    return 0


if __name__ == "__main__":
    sys.exit(main())
