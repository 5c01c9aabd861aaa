"""The port against the framework-free interchange fixtures, without jax.

``docs/interchange/*.json`` pin the conventions of the system (NTT
evaluation points and outputs, gadget digits and rounding, the mod switch,
the clue extraction map, both LUTs, the trace automorphisms, the LWE key
switch) and a noise-free transcript of one message through every stage of
detect, with the secrets that made it (``tools/make_interchange_fixtures.py``,
``tools/make_transcript_fixture.py``). ``tests/test_interchange.py`` checks
the fixtures against their documented invariants in big-int math; this file
holds the port's own modules (``ops/ntt.py``, ``ops/decompose.py``,
``ops/bootstrap.py``, ``core/lut.py``, ``core/context.py``, the key
generation's numpy draws, the Retriever) to them, exactly.

The transcript's ciphertexts after the first blind rotation depend on the
JAX package's key masks, which the port does not draw (its masks come from
``torch.Generator``), so those stages are replayed as the fixture allows:
each recorded input goes through the port's function into the recorded
output where no mask is involved (sum, extraction, key switch with the
numpy-drawn key, mod switch, NTT, digest), and each recorded ciphertext is
decrypted by the port with the recorded secrets (the cases of
``tests/test_interchange.py`` TestTranscript). This file imports no jax:

    python -m pytest tests/test_torch_interchange.py --noconftest -q
"""

import json
import os

import numpy as np
import pytest
import torch

from tfhe_omr_tpu_torch.core.context import OmrContext
from tfhe_omr_tpu_torch.core.detector import index_poly_device
from tfhe_omr_tpu_torch.core.keygen import SecretKeyPack, secret_key_pack_from_numpy
from tfhe_omr_tpu_torch.core.lut import first_level_lut, second_level_lut
from tfhe_omr_tpu_torch.core.params import OmrParameters, RetrievalParams
from tfhe_omr_tpu_torch.core.retriever import Retriever
from tfhe_omr_tpu_torch.ops.bootstrap import (
    extract_constant_lwe, lwe_modulus_switch, make_lwe_keyswitch,
)
from tfhe_omr_tpu_torch.ops.decompose import SignedGadget

torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "docs", "interchange")
FIXTURE_SEED = 20260821  # tools/make_transcript_fixture.py SEED


def load(name):
    with open(os.path.join(FIXDIR, name)) as fp:
        return json.load(fp)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.int64))


@pytest.fixture(scope="module")
def ctx():
    return OmrContext(OmrParameters.default(noise_free=True), "cpu")


@pytest.fixture(scope="module")
def keys(ctx):
    """The fixtures' secrets and key-switching key, drawn by the port's key
    generation from the fixtures' numpy seed in the JAX package's order:
    the secrets, the clue key, the first bootstrapping key's seed, the KSK
    (its masks are numpy draws, so the port's KSK is the fixtures')."""
    skp = SecretKeyPack(ctx.params, rng=FIXTURE_SEED, ctx=ctx)
    sender = skp.generate_sender()
    skp.rng.integers(0, 1 << 62)  # the seed of BSK1's masks (torch.Generator)
    ksk = torch.as_tensor(skp._gen_ksk(skp.rng)).to(torch.float64)
    return skp, sender, ksk


def _keyswitch(ctx, a_vec, b, ksk):
    ksp = ctx.params.first_level_ks
    ks = make_lwe_keyswitch(ctx.f1, ksp.digits, ksp.out_dimension)
    return ks(_t(a_vec), _t(b), ksk)


def _phase(f, ntt, z_ntt, a, b):
    """b - a * z in Z_q[X]/(X^N + 1) through the port's plain NTT."""
    az = ntt.inv_last_plain(f.mul(ntt.fwd_last_plain(_t(a)), z_ntt))
    return f.sub(_t(b), az).numpy()


def _centred_max(a, b, q):
    e = np.mod(np.asarray(a, dtype=object) - np.asarray(b, dtype=object), q)
    return int(max(min(int(x), q - int(x)) for x in e))


# ---------------------------------------------------------------- conventions
@pytest.mark.parametrize("lvl", ["l1", "l2"])
def test_ntt_is_the_fixture(ctx, lvl):
    f = load("ntt.json")[lvl]
    ntt = ctx.ntt1 if lvl == "l1" else ctx.ntt2
    assert (ntt.field.q, ntt.n, ntt.psi) == (f["q"], f["n"], f["psi"])
    assert ntt.orders.tolist() == f["orders"]
    poly = _t(f["poly"])[:, None]
    out = ntt.fwd_plain(poly)[:, 0]
    assert out.tolist() == f["ntt_out"]
    assert ntt.inv_plain(out[:, None])[:, 0].tolist() == f["poly"]


@pytest.mark.parametrize("name", ["br1", "br2", "trace"])
def test_gadget_is_the_fixture(ctx, name):
    g_fix = load("gadget.json")[name]
    field = ctx.f1 if g_fix["q"] == ctx.f1.q else ctx.f2
    g = SignedGadget(field, g_fix["log_b"], g_fix["digits"])
    want_gadget = {"br1": ctx.gadget_br1, "br2": ctx.gadget_br2,
                   "trace": ctx.gadget_trace}[name]
    assert (want_gadget.log_b, want_gadget.d) == (g.log_b, g.d)
    assert g.gadget_values().tolist() == g_fix["gadget_values"]
    digits = g.decompose(_t(g_fix["inputs"]), dim=0)
    assert digits.tolist() == g_fix["digit_rows"]
    assert g.recompose_host(digits.numpy()).tolist() == g_fix["reconstruction_mod_q"]


def test_mod_switch_is_the_fixture(ctx):
    fix = load("mod_switch.json")
    assert fix["q_from"] == ctx.f1.q
    got = lwe_modulus_switch(ctx.f1, _t(fix["inputs"]), fix["q_to"])
    assert got.tolist() == fix["outputs"]


def test_extract_map_is_the_fixture(ctx):
    fix = load("extract_map.json")
    idx, neg = ctx.clue_extract_tables
    assert (ctx.params.clue_count, ctx.params.clue_params.dimension) == (
        fix["clue_count"], fix["n0"])
    assert idx.tolist() == fix["index"] and neg.tolist() == fix["negate"]


def test_luts_are_the_fixture(ctx):
    fix = load("lut.json")
    assert first_level_lut(ctx.params).tolist() == fix["first_level_lut"]
    assert second_level_lut(ctx.params).tolist() == fix["second_level_lut"]


def test_trace_autos_are_the_fixture(ctx):
    fix = load("trace_autos.json")
    assert fix["n2"] == ctx.params.n2
    assert len(ctx.trace_autos) == len(fix["rounds"])
    for (g, gidx, gsign), rd in zip(ctx.trace_autos, fix["rounds"]):
        assert g == rd["g"]
        assert gidx.tolist() == rd["gidx"] and gsign.tolist() == rd["gsign"]


def test_key_switch_is_the_fixture(ctx, keys):
    """The port's key switch with the port's KSK gives the fixture's
    outputs exactly, and the secrets are the fixture's."""
    skp, _sender, ksk = keys
    fix = load("key_switch.json")
    assert skp.z1.tolist() == fix["secrets"]["z1"]
    assert skp.inter_sk.tolist() == fix["secrets"]["s2"]
    a_in = [i["a"] for i in fix["inputs"]]
    b_in = [i["b"] for i in fix["inputs"]]
    ks_a, ks_b = _keyswitch(ctx, a_in, b_in, ksk)
    assert ks_a.tolist() == [o["a"] for o in fix["outputs"]]
    assert ks_b.tolist() == [o["b"] for o in fix["outputs"]]


# ----------------------------------------------------------------- transcript
@pytest.fixture(scope="module")
def tr():
    return load("transcript.json")


def test_clue_and_extraction(ctx, keys, tr):
    """The port's sender draws the recorded clue from the recorded seed;
    its extraction gives the recorded samples, each of phase 0."""
    skp, sender, _ksk = keys
    assert skp.clue_sk.tolist() == tr["secrets"]["clue_sk"]
    assert skp.z2.tolist() == tr["secrets"]["z2"]
    clue = sender.gen_clues(1, np.random.default_rng(FIXTURE_SEED + 1))
    assert np.asarray(clue.a[0]).tolist() == tr["clue"]["a"]
    assert np.asarray(clue.b7[0]).tolist() == tr["clue"]["b7"]
    idx, neg = ctx.clue_extract_tables
    q0 = tr["clue"]["q0"]
    a = np.asarray(tr["clue"]["a"], dtype=np.int64)
    a_ext = np.mod(np.where(neg == 1, -a[idx], a[idx]), q0)
    assert a_ext.tolist() == tr["extracted"]["a_ext"]
    assert skp.decrypt_clue(a_ext, np.asarray(tr["clue"]["b7"])).tolist() == [0] * 7


def test_l1_accumulators_decrypt_to_lut1(ctx, keys, tr):
    skp = keys[0]
    f1 = ctx.f1
    lut1 = first_level_lut(ctx.params)
    for ct in tr["l1_acc_per_clue"]:
        m = _phase(f1, ctx.ntt1, skp.z1_ntt, ct["a"], ct["b"])
        assert _centred_max(m, lut1, f1.q) < f1.q // 64


def test_l1_sum_extraction_key_switch_and_mod_switch(ctx, keys, tr):
    """Sum, sample extraction, key switch (the port's numpy-drawn KSK) and
    mod switch with the offset: each recorded output exactly."""
    ksk = keys[2]
    f1 = ctx.f1
    accs = torch.stack([torch.stack([_t(c["a"]), _t(c["b"])], dim=1)
                        for c in tr["l1_acc_per_clue"]], dim=-1)  # (N, 2, clues)
    acc_sum = f1.mod_sum(accs, dim=2)
    assert acc_sum[:, 0].tolist() == tr["l1_sum"]["a"]
    assert acc_sum[:, 1].tolist() == tr["l1_sum"]["b"]
    a_vec, b0 = extract_constant_lwe(f1, acc_sum[:, :, None])
    assert a_vec[:, 0].tolist() == tr["extracted_lwe"]["a"]
    assert int(b0[0]) == tr["extracted_lwe"]["b"]
    ks_a, ks_b = _keyswitch(ctx, a_vec.T, b0, ksk)
    assert ks_a[0].tolist() == tr["key_switched"]["a"]
    assert int(ks_b[0]) == tr["key_switched"]["b"]
    ms = tr["mod_switched"]
    assert ms["b_offset"] == ctx.params.clue_count * (
        ms["q"] // ctx.params.intermediate_lwe.plain_modulus)
    assert lwe_modulus_switch(f1, ks_a, ms["q"])[0].tolist() == ms["a"]
    ms_b = (lwe_modulus_switch(f1, ks_b, ms["q"]) + ms["b_offset"]) & (ms["q"] - 1)
    assert int(ms_b[0]) == ms["b"]


def test_l2_accumulator_decrypts_to_rotated_lut2(ctx, keys, tr):
    """The L2 accumulator decrypts to X^-phase2 * LUT2 (the port's
    init_accumulator table) within half a window; its constant slot to 1."""
    skp = keys[0]
    f2, ms = ctx.f2, tr["mod_switched"]
    phase2 = (ms["b"] - int(np.dot(ms["a"], skp.inter_sk))) % ms["q"]
    lut2_rot = ctx.lut2_ext[(np.arange(ctx.params.n2) + phase2) % (2 * ctx.params.n2)]
    m = _phase(f2, ctx.ntt2, skp.z2_ntt, tr["l2_acc"]["a"], tr["l2_acc"]["b"])
    t = ctx.params.output_plain_modulus
    assert _centred_max(m, lut2_rot, f2.q) < f2.q // (2 * t)
    assert ((2 * int(m[0]) * t + f2.q) // (2 * f2.q)) % t == 1


def test_trace_output_and_its_ntt(ctx, keys, tr):
    """The trace output decrypts to the L2 phase's constant slot and zeros
    exactly; the port's forward NTT of it is the recorded NTT-domain ct,
    which the port's decrypt takes back to the same phase."""
    skp = keys[0]
    f2, ntt2 = ctx.f2, ctx.ntt2
    m2 = _phase(f2, ntt2, skp.z2_ntt, tr["l2_acc"]["a"], tr["l2_acc"]["b"])
    m_tr = _phase(f2, ntt2, skp.z2_ntt, tr["trace_out"]["a"], tr["trace_out"]["b"])
    assert int(m_tr[0]) == int(m2[0]) and not m_tr[1:].any()
    out = ntt2.fwd_last_plain(torch.stack([_t(tr["trace_out"]["a"]),
                                           _t(tr["trace_out"]["b"])]))
    assert out[0].tolist() == tr["ntt_out"]["a"] and out[1].tolist() == tr["ntt_out"]["b"]
    assert np.array_equal(skp.decrypt_rlwe2_ntt(out[None])[0], m_tr)


def test_index_digest_and_decode(ctx, keys, tr):
    """The port's index plaintext for the recorded buckets, through the
    port's NTT, times the recorded pertinency ct is the recorded digest;
    the port's Retriever decodes it to index 0."""
    skp = keys[0]
    f2, ntt2 = ctx.f2, ctx.ntt2
    rp = RetrievalParams.for_params(ctx.params, 65536, 50)
    lay = tr["digest"]["layout"]
    assert {k: getattr(rp, k) for k in lay} == lay
    base = (np.arange(rp.segment_per_cipher) * rp.slots_per_segment
            + np.asarray(tr["digest"]["buckets"]) * rp.slots_per_bucket)
    poly = index_poly_device(_t(base[None]), _t([0]), rp.index_slots_per_bucket,
                             ctx.params.n2, rp.index_modulus, f2.q)
    pert = torch.stack([_t(tr["ntt_out"]["a"]), _t(tr["ntt_out"]["b"])])
    ct = f2.mul(pert, ntt2.fwd_last_plain(poly))
    assert ct[0].tolist() == tr["digest"]["index_ct"]["a"]
    assert ct[1].tolist() == tr["digest"]["index_ct"]["b"]
    retr = Retriever(rp, ctx, skp.z2_ntt)
    retr.decode_pertinent_indices(ct)
    assert sorted(retr.pertinent_indices_set) == tr["digest"]["decoded_indices"] == [0]


def test_recorded_secrets_decrypt_what_the_port_keys_decrypt(ctx, keys, tr):
    """A pack holding the recorded secrets (``secret_key_pack_from_numpy``)
    is the pack the port drew from the seed."""
    skp = keys[0]
    s = tr["secrets"]
    other = secret_key_pack_from_numpy(ctx.params, s["clue_sk"], s["s2"], s["z1"],
                                       s["z2"], ctx)
    assert torch.equal(other.z1_ntt, skp.z1_ntt) and torch.equal(other.z2_ntt, skp.z2_ntt)
