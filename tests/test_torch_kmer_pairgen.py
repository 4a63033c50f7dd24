"""Port parity: k-mer scan, occurrence sort, capacity plan and candidate-pair
stream of ``sequence_aligner_tpu_torch`` against the JAX package (exact;
intermediates of unstable sorts compared as per-hash multisets)."""

from collections import Counter

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from sequence_aligner_tpu.core.records import Sequence as JSeq
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.ops.encode import encode_reads as j_encode
from sequence_aligner_tpu.ops.kmer import kmer_scan as j_kmer_scan
from sequence_aligner_tpu.ops.pairgen import (
    candidate_pairs_stream as j_stream, plan_totals as j_plan_totals,
    sort_occurrences_jit as j_sort,
)
from sequence_aligner_tpu.pipeline.datasets import simulated_reads as j_sim

from sequence_aligner_tpu_torch.ops import pairgen
from sequence_aligner_tpu_torch.ops.kmer import kmer_scan

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes, and
    the plain versions' many small ops only lose to thread hand-offs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _reads(kind: str):
    """(bases int8 [N, L], lengths int32 [N]) made with numpy from a seed."""
    if kind == "uniform":
        seqs = j_sim(300, 100, coverage=20.0, error_rate=0.01, seed=2)
    else:  # mixed lengths, some shorter than and equal to k
        rng = np.random.RandomState(3)
        base = j_sim(260, 150, coverage=15.0, error_rate=0.01, seed=4)
        cut = rng.randint(40, 151, len(base))
        cut[:6] = [3, 11, 12, 15, 16, 17]
        seqs = [JSeq(q.id, q.seq[: int(c)]) for q, c in zip(base, cut)]
    return j_encode(seqs)


def _geom(s):
    return dict(head_edge=s.kmer_head_edge, tail_edge=s.kmer_tail_edge,
                mid_lead=s.kmer_mid_lead_edge, mid_tail=s.kmer_mid_tail_edge)


def _jgeom(s):
    return {k: jnp.float32(v) for k, v in _geom(s).items()}


def _occ_both(bases, lengths, k):
    ids = np.arange(1, bases.shape[0] + 1, dtype=np.int32)
    j = j_kmer_scan(jnp.asarray(bases), jnp.asarray(lengths), jnp.asarray(ids), k)
    t = kmer_scan(torch.from_numpy(bases), torch.from_numpy(lengths),
                  torch.from_numpy(ids), k)
    return {f: np.asarray(v) for f, v in j.items()}, t


@pytest.mark.parametrize("k", [12, 16])
@pytest.mark.parametrize("kind", ["uniform", "mixed"])
def test_kmer_scan_matches(kind, k):
    bases, lengths = _reads(kind)
    j, t = _occ_both(bases, lengths, k)
    for f in ("hash", "read_id", "valid"):
        assert np.array_equal(t[f].numpy(), j[f]), f
    # float32 loc bit for bit (0/0 -> NaN where a read is exactly k long)
    assert np.array_equal(t["loc"].numpy().view(np.int32), j["loc"].view(np.int32))
    if kind == "mixed":
        assert np.isnan(j["loc"][j["valid"]]).any()
    if k == 16:  # the int32 wrap of (h << 2) ^ code is exercised
        assert (j["hash"] < 0).any()


@pytest.mark.parametrize("kind", ["uniform", "mixed"])
def test_sorted_occurrences_per_hash(kind):
    bases, lengths = _reads(kind)
    j, t = _occ_both(bases, lengths, 12)
    js = {f: np.asarray(v) for f, v in j_sort({f: jnp.asarray(v) for f, v in j.items()}).items()}
    ts = pairgen.sort_occurrences(t)
    th = ts["hash"].numpy()
    assert (np.diff(th.astype(np.int64)) >= 0).all()
    v = js["valid"]
    want = Counter(zip(js["hash"][v], js["read_id"][v], js["loc"][v].view(np.int32)))
    got = Counter(zip(th, ts["read_id"].numpy(), ts["loc"].numpy().view(np.int32)))
    assert got == want


@pytest.mark.parametrize("profile", ["default", "amos_parity"])
@pytest.mark.parametrize("kind", ["uniform", "mixed"])
def test_plan_totals_match(kind, profile):
    s = JSettings() if profile == "default" else JSettings.amos_parity()
    bases, lengths = _reads(kind)
    j, t = _occ_both(bases, lengths, s.kmer_size)
    jt = j_plan_totals(j_sort({f: jnp.asarray(v) for f, v in j.items()}), **_jgeom(s))
    tt = pairgen.plan_totals(pairgen.sort_occurrences(t), **_geom(s))
    assert tt == jt and tt[0] > 0


def test_plan_totals_exact_past_int32():
    """One hash shared by 2^16 occurrences, every row head + middle + tail:
    both totals are exactly 2^32 (the JAX package's own regression case)."""
    n = 1 << 16
    occ = dict(hash=np.zeros(n, np.int32), read_id=np.arange(1, n + 1, dtype=np.int32),
               loc=np.full(n, 0.5, np.float32), valid=np.ones(n, bool))
    geom = dict(head_edge=1.0, tail_edge=0.0, mid_lead=0.0, mid_tail=1.0)
    jt = j_plan_totals({f: jnp.asarray(v) for f, v in occ.items()},
                       **{k: jnp.float32(v) for k, v in geom.items()})
    tt = pairgen.plan_totals(
        pairgen.sort_occurrences({f: torch.from_numpy(v) for f, v in occ.items()}), **geom)
    assert tt == jt == (n * n, n * n)


def _caps(h_tot, t_tot, out):
    return dict(cap_head=max(h_tot, 1) + 128, cap_tail=max(t_tot, 1) + 128, cap_out=out)


def _stream_both(occ_np, s, *, min_c, max_c, caps, chunk=pairgen.EXPAND_CHUNK):
    j = j_stream({f: jnp.asarray(v) for f, v in occ_np.items()}, **_jgeom(s),
                 min_collisions=jnp.int32(min_c), max_collisions=jnp.int32(max_c),
                 packed_ids=True, **caps)
    t = pairgen.candidate_pairs_stream(
        pairgen.sort_occurrences({f: torch.from_numpy(np.array(v)) for f, v in occ_np.items()}),
        **_geom(s), min_collisions=min_c, max_collisions=max_c, chunk=chunk, **caps)
    return j, t


def _assert_streams_equal(j, t):
    assert t["n_out"] == int(j["n_out"]) and t["n_out"] > 0
    assert (t["h_tot"], t["t_tot"]) == (int(j["h_tot"]), int(j["t_tot"]))
    assert t["overflow"] == bool(j["overflow"])
    for f in ("lead", "trail", "count"):
        assert np.array_equal(t[f].numpy(), np.asarray(j[f])), f


@pytest.mark.parametrize("chunk", [pairgen.EXPAND_CHUNK, 517])
@pytest.mark.parametrize("band", ["all", "default"])
@pytest.mark.parametrize("kind", ["uniform", "mixed"])
def test_candidate_pairs_stream_matches(kind, band, chunk):
    """Pair set, counts, n_out, h_tot, t_tot and overflow; 517-slot chunks
    (not a run-boundary multiple) force many chunk boundaries."""
    s = JSettings()
    bases, lengths = _reads(kind)
    j_occ, _ = _occ_both(bases, lengths, s.kmer_size)
    h_tot, t_tot = j_plan_totals(j_sort({f: jnp.asarray(v) for f, v in j_occ.items()}),
                                 **_jgeom(s))
    min_c, max_c = (1, 10**9) if band == "all" else (s.min_collisions, s.max_collisions)
    j, t = _stream_both(j_occ, s, min_c=min_c, max_c=max_c,
                        caps=_caps(h_tot, t_tot, (h_tot + t_tot) // min_c + 64), chunk=chunk)
    _assert_streams_equal(j, t)
    assert not t["overflow"]


def test_candidate_pairs_read_ids_near_65535():
    """Read ids in the upper half of the 16-bit space, up to 65535."""
    rng = np.random.RandomState(3)
    n = 4096
    ids = rng.randint(30000, 65536, n).astype(np.int32)
    ids[:8] = 65535
    occ = dict(hash=rng.randint(0, 37, n).astype(np.int32), read_id=ids,
               loc=rng.rand(n).astype(np.float32), valid=rng.rand(n) < 0.95)
    s = JSettings.amos_parity()
    j, t = _stream_both(occ, s, min_c=s.min_collisions, max_c=s.max_collisions,
                        caps=dict(cap_head=1 << 18, cap_tail=1 << 18, cap_out=1 << 16))
    _assert_streams_equal(j, t)
    assert int(t["lead"].max()) >= 1 << 15


def test_candidate_pairs_overflow_flag():
    s = JSettings()
    bases, lengths = _reads("uniform")
    j_occ, _ = _occ_both(bases, lengths, s.kmer_size)
    j, t = _stream_both(j_occ, s, min_c=1, max_c=10**9,
                        caps=dict(cap_head=1000, cap_tail=1 << 20, cap_out=1 << 20))
    assert t["overflow"] and bool(j["overflow"])
    assert (t["h_tot"], t["t_tot"]) == (int(j["h_tot"]), int(j["t_tot"]))


def test_candidate_pairs_rejects_ids_past_16_bits():
    """Where pairs are keyed in 16 bits (the prescreen's key), ids past 16
    bits are refused; the unscreened int64 key takes them."""
    occ = dict(hash=torch.zeros(4, dtype=torch.int32),
               read_id=torch.tensor([1, 2, 3, 65536], dtype=torch.int32),
               loc=torch.tensor([0.2, 0.5, 0.8, 0.5]), valid=torch.ones(4, dtype=torch.bool),
               pos=torch.zeros(4, dtype=torch.int32))
    kw = dict(**_geom(JSettings()), min_collisions=1, max_collisions=9, cap_head=64,
              cap_tail=64, cap_out=64)
    with pytest.raises(ValueError, match="16-bit"):
        pairgen.candidate_pairs_stream(pairgen.sort_occurrences(occ), prescreen_w=4, **kw)
    out = pairgen.candidate_pairs_stream(pairgen.sort_occurrences(occ), **kw)
    assert out["n_out"] == 4 and not out["overflow"]
    assert out["lead"][:4].tolist() == [2, 3, 3, 65536]
