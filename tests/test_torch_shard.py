"""Port parity for the sharded engine (``sequence_aligner_tpu_torch.parallel``)
against the JAX package's ``parallel.shard`` on its virtual CPU mesh
(tests/conftest.py) and against the port's single-device engine.

The port runs over gloo with 1, 2 and 4 ranks, each rank a spawned process
on the CPU; every rank must return the records of the JAX engine on as many
devices, and keep as many pairs as the JAX pairs step's ``n_out`` on the
same device.  Inputs are simulated reads made with numpy from a seed, of two
lengths (two band widths); the tolerance is 0.
"""

import datetime
import multiprocessing
import socket

import numpy as np
import jax  # noqa: F401  (JAX stays on the CPU, as tests/conftest.py forces)
import pytest
import torch

import sequence_aligner_tpu.parallel.shard as j_shard
from sequence_aligner_tpu.core.records import Sequence as JSequence
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.models.overlapper import Overlapper as JOverlapper
from sequence_aligner_tpu.parallel.mesh import make_mesh

from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import AlignSettings
from sequence_aligner_tpu_torch.models.overlapper import Overlapper
from sequence_aligner_tpu_torch.ops import pairgen
from sequence_aligner_tpu_torch.ops.encode import encode_reads
from sequence_aligner_tpu_torch.ops.kmer import kmer_scan
from sequence_aligner_tpu_torch.parallel import shard
from sequence_aligner_tpu_torch.pipeline.datasets import shred_genome, simulated_reads

WORLDS = (1, 2, 4)
# two read lengths, two band widths (8 and 13), as __graft_entry__.py's
# sharded dry run builds them
KW = dict(kmer_size=8, min_identity=0.9, max_ignore=200)
JOIN_S = 120  # a hang fails one test, not the suite


def mixed_reads() -> list[Sequence]:
    rng = np.random.RandomState(5)
    genome = "".join("ACTG"[i] for i in rng.randint(0, 4, 3000))
    a = shred_genome(genome, 100, 120, error_rate=0.01, seed=1)
    b = shred_genome(genome, 100, 64, error_rate=0.01, seed=2)
    return [Sequence(i + 1, q.seq) for i, q in enumerate(x for ab in zip(a, b) for x in ab)]


def _arrays(recs) -> tuple:
    return tuple(np.asarray([getattr(r, f) for r in recs], np.int32)
                 for f in ("id_a", "id_b", "ahg", "bhg"))


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _rank_main(rank, world, port, seqs, settings, path):
    """One rank: join the gloo group, run the port's sharded engine on the
    CPU, save its arrays and the kept pairs of every rank."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        stats = {}
        arrs = shard.sharded_overlap_arrays(seqs, settings, dist.group.WORLD, device="cpu",
                                            stats=stats)
        np.savez(path, *arrs, pairs=np.asarray(stats["pairs_by_rank"]))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, seqs, settings, tmp_path):
    """The port's sharded engine over ``world`` spawned gloo ranks: per rank
    (arrays, pairs kept by each rank)."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    paths = [tmp_path / f"rank{r}_of_{world}.npz" for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, seqs, settings, str(p)))
             for r, p in enumerate(paths)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        assert not any(p.is_alive() for p in procs), f"a rank of {world} hung"
        assert [p.exitcode for p in procs] == [0] * world
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    out = []
    for p in paths:
        z = np.load(p)
        out.append((tuple(z[f"arr_{i}"] for i in range(4)), z["pairs"].tolist()))
    return out


@pytest.fixture(scope="module")
def reads():
    seqs = mixed_reads()
    assert len({AlignSettings(**KW).band_width(len(q.seq)) for q in seqs}) == 2
    return seqs


@pytest.fixture(scope="module")
def jax_runs(reads):
    """JAX ``sharded_overlap`` on 1, 2 and 4 devices: world -> (arrays,
    n_out of each device from the last pairs-step call)."""
    js = JSettings.amos_parity(**KW)
    jseqs = [JSequence(q.id, q.seq) for q in reads]
    n_out = []
    orig = j_shard.make_sharded_pairs_step

    def capture(*a, **k):
        step = orig(*a, **k)

        def run(*x):
            out = step(*x)
            n_out.append(np.asarray(out[2]).tolist())
            return out
        return run

    j_shard.make_sharded_pairs_step = capture
    try:
        res = {w: (_arrays(j_shard.sharded_overlap(jseqs, js, make_mesh(w))), n_out[-1])
               for w in WORLDS}
    finally:
        j_shard.make_sharded_pairs_step = orig
    return res


@pytest.fixture(scope="module")
def port_runs(reads, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    return {w: run_ranks(w, reads, AlignSettings.amos_parity(**KW), tmp) for w in WORLDS}


@pytest.fixture(scope="module")
def single(reads):
    return Overlapper(AlignSettings.amos_parity(**KW), device="cpu").run_arrays(reads)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_equals_jax_and_single_device(world, port_runs, jax_runs, single):
    want, _ = jax_runs[world]
    assert len(want[0]) > 100
    for arrs, _ in port_runs[world]:  # every rank holds every record
        for got, j, one in zip(arrs, want, single):
            assert np.array_equal(got, j) and np.array_equal(got, one)


@pytest.mark.parametrize("world", WORLDS)
def test_kept_pairs_per_rank_equal_jax_n_out(world, port_runs, jax_runs):
    _, n_out = jax_runs[world]
    assert len(n_out) == world and min(n_out) > 0
    for _, pairs in port_runs[world]:
        assert pairs == n_out


def _three_reads():
    seqs = simulated_reads(3, 100, coverage=2.0, seed=8)
    return seqs


def _no_shared_kmer():
    # 40 random 30 bp reads share no 12-mer (checked below on the table)
    rng = np.random.RandomState(9)
    return [Sequence(i + 1, "".join("ACTG"[c] for c in rng.randint(0, 4, 30)))
            for i in range(40)]


@pytest.mark.parametrize("make", [_three_reads, _no_shared_kmer],
                         ids=["three_reads_on_four_ranks", "no_shared_kmer"])
def test_edge_cases_on_four_ranks_end(make, tmp_path):
    """Fewer reads than ranks (one rank holds only padding) and reads with
    no pair at all: every rank still issues every collective and ends."""
    seqs = make()
    s = AlignSettings.amos_parity()
    want = Overlapper(s, device="cpu").run_arrays(seqs)
    jwant = _arrays(JOverlapper(JSettings.amos_parity()).run(
        [JSequence(q.id, q.seq) for q in seqs]))
    if make is _no_shared_kmer:
        bases, lengths = encode_reads(seqs)
        h = kmer_scan(torch.from_numpy(bases), torch.from_numpy(lengths),
                      torch.arange(1, len(seqs) + 1, dtype=torch.int32), s.kmer_size)
        ok = h["valid"]
        assert torch.unique(h["hash"][ok]).numel() == int(ok.sum())
        assert len(want[0]) == 0
    else:
        assert len(want[0]) > 0
    for arrs, pairs in run_ranks(4, seqs, s, tmp_path):
        assert len(pairs) == 4
        for got, one, j in zip(arrs, want, jwant):
            assert np.array_equal(got, one) and np.array_equal(got, j)


@pytest.mark.parametrize("world", [2, 3, 4, 7])
def test_owner_rules_are_the_jax_uint32_rules(world):
    """hash mod world and (lead * 2654435761 ^ trail) mod world, both in
    uint32, as the JAX engine computes them (shard.py:336, :494-497)."""
    rng = np.random.RandomState(world)
    h = np.concatenate([rng.randint(-2**31, 2**31, 1000), [-2**31, -1, 0, 2**31 - 1]])
    h = h.astype(np.int32)
    want = (h.astype(np.uint32) % np.uint32(world)).astype(np.int64)
    got = (torch.from_numpy(h).to(torch.int64) & shard._M32) % world
    assert np.array_equal(got.numpy(), want)
    fst = rng.randint(1, 2**31 - 1, 1000).astype(np.int64)
    snd = rng.randint(1, 2**31 - 1, 1000).astype(np.int64)
    fst[:2], snd[:2] = 2**31 - 1, 65535
    jw = ((fst.astype(np.uint32) * np.uint32(shard._PAIR_HASH)) ^ snd.astype(np.uint32)) \
        % np.uint32(world)
    key = torch.from_numpy(fst << 32 | snd)
    f, sn = key >> 32, key & shard._M32
    got = (((f * shard._PAIR_HASH) & shard._M32) ^ sn) % world
    assert np.array_equal(got.numpy(), jw.astype(np.int64))


@pytest.mark.parametrize("screen", [False, True])
def test_pair_counts_then_band_is_candidate_pairs_stream(screen):
    """The two halves of ``candidate_pairs_stream`` give its outputs."""
    s = AlignSettings()
    seqs = simulated_reads(400, 100, coverage=12.0, error_rate=0.01, seed=6)
    bases, lengths = encode_reads(seqs)
    occ = kmer_scan(torch.from_numpy(bases), torch.from_numpy(lengths),
                    torch.arange(1, len(seqs) + 1, dtype=torch.int32), s.kmer_size)
    occ_s = pairgen.sort_occurrences(occ)
    geom = dict(head_edge=s.kmer_head_edge, tail_edge=s.kmer_tail_edge,
                mid_lead=s.kmer_mid_lead_edge, mid_tail=s.kmer_mid_tail_edge)
    h_tot, t_tot = pairgen.plan_totals(occ_s, **geom)
    caps = dict(cap_head=h_tot, cap_tail=t_tot)
    w = 3 if screen else None
    full = pairgen.candidate_pairs_stream(occ_s, **geom, **caps, cap_out=1 << 14,
                                          min_collisions=s.min_collisions,
                                          max_collisions=s.max_collisions, prescreen_w=w)
    uniq, cnt, h2, t2 = pairgen.pair_counts(occ_s, **geom, **caps, prescreen_w=w)
    assert (h2, t2) == (h_tot, t_tot) and torch.all(uniq[1:] > uniq[:-1])
    assert int(cnt.sum()) >= full["n_out"] * s.min_collisions
    band = pairgen.band_pairs(uniq, cnt, min_collisions=s.min_collisions,
                              max_collisions=s.max_collisions, cap_out=1 << 14,
                              shift=16 if screen else 32)
    assert band["n_out"] == full["n_out"] > 0
    for f in ("lead", "trail", "count"):
        assert torch.equal(band[f], full[f])


def test_one_rank_on_the_cpu_caps_and_timing_line(reads, single, monkeypatch, capsys):
    """``sharded_overlap`` with no group runs one gloo rank and leaves no
    group behind; the JAX capacity names are accepted, others refused; the
    timing line is the JAX engine's."""
    import torch.distributed as dist

    s = AlignSettings.amos_parity(**KW)
    monkeypatch.setenv("SEQALIGN_DIST_TIMING", "1")
    recs = shard.sharded_overlap(reads, s, device="cpu", caps={"cap_out": 64, "cap_route": 8})
    assert not dist.is_initialized()
    for got, one in zip(_arrays(recs), single):
        assert np.array_equal(got, one)
    err = capsys.readouterr().err
    line = [ln for ln in err.splitlines() if ln.startswith("# sharded_overlap timing ")]
    assert len(line) == 1
    for key in ("plan", "pairs", "align_dispatch", "align_fetch_sort", "total", "n_records"):
        assert f'"{key}"' in line[0]
    with pytest.raises(ValueError, match="cap_bogus"):
        shard.sharded_overlap(reads, s, device="cpu", caps={"cap_bogus": 1})
