"""Port parity for read ids past 16 bits in ``sequence_aligner_tpu_torch``:
the candidate table against the JAX package's ``packed_ids=False`` branch,
the prescreen's 16-bit key against the port's int64 key, and the engine on
more than 65,536 reads against the JAX engine.  Inputs are made with numpy
from a seed; the tolerance is 0."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import sequence_aligner_tpu.ops.pairgen as j_pg
from sequence_aligner_tpu.core.records import Sequence as JSeq
from sequence_aligner_tpu.core.settings import AlignSettings as JSettings
from sequence_aligner_tpu.models.overlapper import Overlapper as JOverlapper

from sequence_aligner_tpu_torch.core.records import Sequence
from sequence_aligner_tpu_torch.core.settings import settings_from_jax
from sequence_aligner_tpu_torch.models.overlapper import Overlapper
from sequence_aligner_tpu_torch.ops import pairgen


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _geom(s):
    return dict(head_edge=s.kmer_head_edge, tail_edge=s.kmer_tail_edge,
                mid_lead=s.kmer_mid_lead_edge, mid_tail=s.kmer_mid_tail_edge)


def _occ(seed, n, id_lo, id_hi, n_hash=37):
    """A random occurrence table: ids in [id_lo, id_hi], a few hashes shared
    by many rows, random loc and validity."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(id_lo, id_hi + 1, n).astype(np.int32)
    ids[:4] = id_hi
    return dict(hash=rng.randint(0, n_hash, n).astype(np.int32), read_id=ids,
                loc=rng.rand(n).astype(np.float32), valid=rng.rand(n) < 0.95)


def _port_stream(occ, s, *, chunk=pairgen.EXPAND_CHUNK, **kw):
    return pairgen.candidate_pairs_stream(
        pairgen.sort_occurrences({f: torch.from_numpy(v) for f, v in occ.items()}),
        **_geom(s), min_collisions=s.min_collisions, max_collisions=s.max_collisions,
        chunk=chunk, **kw)


@pytest.mark.parametrize("chunk", [pairgen.EXPAND_CHUNK, 517])
@pytest.mark.parametrize("seed,id_lo,id_hi", [
    (1, 65536, 70000),               # just past the 16-bit key
    (2, 1 << 20, (1 << 31) - 2),     # up to near 2^31
])
def test_general_ids_match_jax(seed, id_lo, id_hi, chunk, monkeypatch):
    """Pair table, counts, n_out, h_tot, t_tot and overflow against the JAX
    general path (which pads its table to its own capacity tier, so the
    tables are compared on the n_out kept pairs); 517-slot chunks (not a
    run-boundary multiple) force many chunk boundaries on both sides."""
    occ = _occ(seed, 3000, id_lo, id_hi)
    s = JSettings.amos_parity()
    caps = dict(cap_head=1 << 18, cap_tail=1 << 18, cap_out=1 << 17)
    if chunk != pairgen.EXPAND_CHUNK:
        monkeypatch.setattr(j_pg, "_EXPAND_CHUNK", chunk)
    j = j_pg.candidate_pairs_stream(
        {f: jnp.asarray(v) for f, v in occ.items()},
        **{k: jnp.float32(v) for k, v in _geom(s).items()},
        min_collisions=jnp.int32(s.min_collisions),
        max_collisions=jnp.int32(s.max_collisions), packed_ids=False, **caps)
    t = _port_stream(occ, s, chunk=chunk, **caps)
    k = t["n_out"]
    assert k == int(j["n_out"]) and k > 0
    assert (t["h_tot"], t["t_tot"]) == (int(j["h_tot"]), int(j["t_tot"]))
    assert t["overflow"] is False and not bool(j["overflow"])
    for f in ("lead", "trail", "count"):
        assert np.array_equal(t[f][:k].numpy(), np.asarray(j[f])[:k]), f
        assert not t[f][k:].any(), f
    assert int(t["lead"].max()) >= id_lo


def _with_pos(occ, seed):
    """The table with integer k-mer positions, as the prescreen needs."""
    return dict(occ, pos=np.random.RandomState(seed).randint(0, 89, len(occ["hash"]))
                .astype(np.int32))


@pytest.mark.parametrize("chunk", [pairgen.EXPAND_CHUNK, 517])
def test_prescreen_key_with_an_open_window_gives_the_plain_table(chunk):
    """Ids in the upper half of the 16-bit space: the prescreen's
    (lead << 16 | trail, diagonal) sort with a window no diagonal gap
    exceeds keeps every run, so its table equals the unscreened int64-key
    table slot for slot."""
    occ = _with_pos(_occ(3, 4096, 30000, 65535), seed=3)
    s = JSettings.amos_parity()
    caps = dict(cap_head=1 << 18, cap_tail=1 << 18, cap_out=1 << 16)
    a = _port_stream(occ, s, chunk=chunk, **caps)
    b = _port_stream(occ, s, chunk=chunk, prescreen_w=1 << 20, **caps)
    k = a["n_out"]
    assert k == b["n_out"] and k > 0
    assert (a["h_tot"], a["t_tot"]) == (b["h_tot"], b["t_tot"])
    for f in ("lead", "trail", "count"):
        assert torch.equal(a[f], b[f]), f
    assert int(a["lead"][:k].max()) >= 1 << 15


def test_general_overflow_flag():
    occ = _occ(4, 2000, 65536, 90000)
    s = JSettings.amos_parity()
    t = _port_stream(occ, s, cap_head=1000, cap_tail=1 << 18,
                     cap_out=1 << 17)
    assert t["overflow"] and t["h_tot"] > 1000


def _sparse_reads(n_total, n_real, seed):
    """n_total reads, most of them empty or shorter than k; n_real reads of
    60..80 bp from a random genome (1% substitutions) at ids past 65,536."""
    rng = np.random.RandomState(seed)
    genome = "".join("ACTG"[i] for i in rng.randint(0, 4, n_real * 70 // 12))
    seqs = ["ACGT" if i % 3 == 0 else "" for i in range(n_total)]
    ids = rng.choice(np.arange(65537, n_total + 1), n_real, replace=False)
    for i in ids:
        ln = rng.randint(60, 81)
        st = rng.randint(0, len(genome) - ln)
        body = list(genome[st : st + ln])
        for p in rng.randint(0, ln, rng.binomial(ln, 0.01)):
            body[p] = "ACTG"[rng.randint(0, 4)]
        seqs[i - 1] = "".join(body)
    return seqs


def test_engine_past_16_bit_ids_matches_jax():
    """run_arrays on 70,000 reads — 2,500 real reads at ids 65,537..70,000
    — against the JAX engine, which pads to a tier of 131,072 reads and so
    takes its general-id pair path."""
    raw = _sparse_reads(70000, 2500, seed=5)
    js = JSettings.amos_parity()
    want = JOverlapper(js).run_arrays([JSeq(i + 1, q) for i, q in enumerate(raw)])
    ov = Overlapper(settings_from_jax(js), device="cpu")
    got = ov.run_arrays([Sequence(i + 1, q) for i, q in enumerate(raw)])
    assert not ov._packed_ids
    assert len(want[0]) > 100 and int(np.asarray(want[0]).min()) > 65536
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))
