"""Port parity for the multi-process layer (``sequence_aligner_tpu_torch.dist``)
and the CLI's ``--engine sharded`` against the JAX package, on the CPU.

``python -m sequence_aligner_tpu_torch.dist.worker`` runs as two gloo
processes (and as one) and must write the ``.ovl`` bytes of the JAX
single-device engine's ``write_ovl``; the port's CLI with ``--engine sharded
--device cpu`` must write the JAX CLI's ``--engine sharded`` bytes.  Inputs
are simulated reads of two lengths made with numpy from a seed; the
tolerance is 0.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax  # noqa: F401  (JAX stays on the CPU, as tests/conftest.py forces)
import pytest
import torch
import torch.distributed as dist

from sequence_aligner_tpu.cli import main as j_main
from sequence_aligner_tpu.core.records import Sequence as JSequence
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.io.fasta import read_fasta as j_read_fasta
from sequence_aligner_tpu.io.ovl import write_ovl as j_write_ovl
from sequence_aligner_tpu.models.overlapper import Overlapper as JOverlapper

from sequence_aligner_tpu_torch.cli import main as p_main
from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.dist import distributed_group, initialize_distributed
from sequence_aligner_tpu_torch.pipeline.datasets import shred_genome, write_seq

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 180  # a hang fails one test, not the suite
# the settings as flags of both CLIs and of the worker
K, MIN_ID, MAX_IGNORE = 8, 0.9, 200


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A FASTA of 200 reads of 120 and 64 bp, and the JAX single-device
    engine's OVL of it (amos_parity, k = 8, min_identity 0.9)."""
    tmp = tmp_path_factory.mktemp("dist")
    rng = np.random.RandomState(11)
    genome = "".join("ACTG"[i] for i in rng.randint(0, 4, 3000))
    a = shred_genome(genome, 100, 120, error_rate=0.01, seed=3)
    b = shred_genome(genome, 100, 64, error_rate=0.01, seed=4)
    seqs = [Sequence(i + 1, q.seq) for i, q in enumerate(x for ab in zip(a, b) for x in ab)]
    fasta = tmp / "reads.fasta"
    write_seq(seqs, str(fasta))
    js = JSettings.amos_parity(kmer_size=K, min_identity=MIN_ID, max_ignore=MAX_IGNORE)
    want = tmp / "jax.ovl"
    recs = JOverlapper(js).run([JSequence(q.id, q.seq) for q in seqs])
    j_write_ovl(recs, str(want))
    assert len(recs) > 100 and len({js.band_width(len(q.seq)) for q in seqs}) == 2
    return dict(fasta=str(fasta), want=want.read_bytes())


def _worker(args: list[str], out: Path) -> list[str]:
    return [sys.executable, "-m", "sequence_aligner_tpu_torch.dist.worker", *args,
            "--device", "cpu", "--amos-parity", "--kmer-size", str(K), "-o", str(out)]


def _run_workers(cmds: list[list[str]]):
    """Run the commands at once; (returncode, stdout, stderr) of each."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    try:
        res = [p.communicate(timeout=WAIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, *r) for p, r in zip(procs, res)]


@pytest.mark.parametrize("nprocs", [2, 1])
def test_worker_writes_the_jax_engines_bytes(files, nprocs, tmp_path):
    """``dist.worker`` over ``nprocs`` gloo processes (one without a
    coordinator) writes the JAX single-device engine's OVL bytes at the
    worker's settings (amos_parity, k = 8: the worker, as the JAX one, has
    no flag for min_identity or max_ignore)."""
    out = tmp_path / "out.ovl"
    if nprocs == 1:
        cmds = [_worker(["-i", files["fasta"]], out)]
    else:
        port = _free_port()
        cmds = [_worker(["--coordinator", f"127.0.0.1:{port}", "--nprocs", str(nprocs),
                         "--pid", str(i), "-i", files["fasta"],
                         "--cap", "cap_out=64", "--cap", "cap_head=1024"], out)
                for i in range(nprocs)]
    res = _run_workers(cmds)
    assert [r[0] for r in res] == [0] * nprocs, [r[2][-2000:] for r in res]
    js = JSettings.amos_parity(kmer_size=K)
    want = tmp_path / "want.ovl"
    n = j_write_ovl(JOverlapper(js).run(j_read_fasta(files["fasta"])), str(want))
    assert n > 0 and out.read_bytes() == want.read_bytes()
    assert f"# wrote {n} overlaps across {nprocs} processes / {nprocs} devices" in res[0][2]


def test_worker_refuses_a_capacity_the_jax_engine_lacks(files, tmp_path):
    res = _run_workers([_worker(["-i", files["fasta"], "--cap", "cap_bogus=1"],
                                tmp_path / "o.ovl")])
    assert res[0][0] != 0 and "cap_bogus" in res[0][2]
    assert not (tmp_path / "o.ovl").exists()


def _cli(main, files, out, extra):
    rc = main(["-i", files["fasta"], "-o", str(out), "--engine", "sharded", "--amos-parity",
               "-k", str(K), "--min-identity", str(MIN_ID), "--max-ignore", str(MAX_IGNORE),
               *extra])
    assert rc == 0


def test_cli_engine_sharded_writes_the_jax_clis_bytes(files, tmp_path):
    p_out, j_out = tmp_path / "port.ovl", tmp_path / "jax.ovl"
    _cli(p_main, files, p_out, ["--device", "cpu"])
    assert not dist.is_initialized()  # the one-rank group is gone
    _cli(j_main, files, j_out, [])
    assert p_out.read_bytes() == j_out.read_bytes() == files["want"]


def test_initialize_distributed_without_a_cluster_is_one_rank(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        distributed_group()
    dev = initialize_distributed(device="cpu")
    try:
        g = distributed_group()
        assert dev == torch.device("cpu")
        assert (dist.get_backend(g), dist.get_world_size(g), dist.get_rank(g)) == ("gloo", 1, 0)
    finally:
        dist.destroy_process_group()


def test_initialize_distributed_reads_torchruns_environment(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("LOCAL_RANK", "0")
    initialize_distributed(device="cpu")
    try:
        assert dist.get_world_size(distributed_group()) == 1
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
