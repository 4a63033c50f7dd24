"""Multi-process overlap worker (port of ``sequence_aligner_tpu/dist/worker.py``).

One process a device.  Every process joins the group
(``dist.init.initialize_distributed``), reads the whole input FASTA, runs
the sharded engine (``parallel.shard.sharded_overlap``) over the group, and
rank 0 writes the ``.ovl`` file.

One line a process, on the CPU (gloo):

  python -m sequence_aligner_tpu_torch.dist.worker \\
      --coordinator HOST:PORT --nprocs N --pid I --device cpu \\
      -i reads.fasta -o out.ovl [--amos-parity] [--kmer-size K] ...

or one command for a host's cards (NCCL; ``torchrun`` sets the ranks):

  torchrun --nproc-per-node N -m sequence_aligner_tpu_torch.dist.worker \\
      -i reads.fasta -o out.ovl

Without ``--coordinator`` and outside ``torchrun`` it is one process.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None, help="HOST:PORT of process 0")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="one card a process (NCCL), or the CPU (gloo)")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--amos-parity", action="store_true")
    ap.add_argument("--kmer-size", type=int, default=12)
    ap.add_argument("--min-collisions", type=int, default=None)
    ap.add_argument(
        "--cap", action="append", default=[], metavar="NAME=N",
        help="a JAX engine capacity (cap_route, cap_head, cap_tail, cap_agg, "
             "cap_pair_route, cap_out, ...): accepted, without effect here; repeatable",
    )
    args = ap.parse_args(argv)
    caps = {}
    for spec in args.cap:
        name, _, val = spec.partition("=")
        caps[name] = int(val)

    import torch.distributed as dist

    from sequence_aligner_tpu_torch.core.settings import AlignSettings
    from sequence_aligner_tpu_torch.dist.init import distributed_group, initialize_distributed
    from sequence_aligner_tpu_torch.io.fasta import read_fasta
    from sequence_aligner_tpu_torch.io.ovl import write_ovl
    from sequence_aligner_tpu_torch.parallel.shard import check_caps, sharded_overlap

    try:
        check_caps(caps)
    except ValueError as e:
        ap.error(str(e))
    kw = {"kmer_size": args.kmer_size}
    if args.min_collisions is not None:
        kw["min_collisions"] = args.min_collisions
    s = AlignSettings.amos_parity(**kw) if args.amos_parity else AlignSettings(**kw)
    dev = initialize_distributed(args.coordinator, args.nprocs, args.pid, device=args.device)
    try:
        recs = sharded_overlap(read_fasta(args.input), s, distributed_group(), device=dev,
                               caps=caps or None)
        if dist.get_rank() == 0:
            write_ovl(recs, args.output)
            n = dist.get_world_size()
            print(f"# wrote {len(recs)} overlaps across {n} processes / {n} devices",
                  file=sys.stderr)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
