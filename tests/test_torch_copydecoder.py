"""The port's sequence package against the JAX package's on the CPU, at a
small size (vocabulary of 8 tokens, embedding 10, hidden 8, memories of
width 7, ``max_seq_len`` 6, 5 target rows and 16 memory slots of which 9
are real): the GRU; the decoder's log-probabilities and its copy-marginalised
loss with converted params (values and gradients), with UNK generation
blocked where a copy exists and with a copy score that dominates every
vocabulary score; ``finalize_minibatch`` and the copy groups bitwise; greedy
decode on the device loop and the host loop, temperature sampling, beam
decode (beam 1 is greedy, beams sorted, tokens and scores equal to JAX's,
also with every score tied); and Luong attention.

Tolerances. Outputs rtol/atol 1e-5 (float32 products add in another order).
The loss to rtol 1e-5, and every gradient to rtol 1e-4 and 1e-4 of its
tensor's largest magnitude. Decoded tokens exactly, their log-probabilities
to 1e-5. Dropout is 0: torch cannot reproduce JAX's random bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.nn.layers import GRU as JaxGRU
from ptgnn_tpu.sequence.grucopydecoder import DecoderData as JaxDecoderData
from ptgnn_tpu.sequence.grucopydecoder import GruCopyingDecoderModel as JaxDecoderModel
from ptgnn_tpu.sequence.luongattention import LuongAttentionModule as JaxLuong
from ptgnn_tpu_torch.nn.layers import GRU
from ptgnn_tpu_torch.sequence import DecoderData, GruCopyingDecoderModel, LuongAttentionModule

INPUTS = [["alpha", "beta", "gamma", "alpha"], ["delta", "rare_tok"], ["beta", "beta", "epsilon"]]
TARGETS = [["alpha", "beta"], ["rare_tok", "delta", "zeta"], ["beta"]]
B_PAD, M_PAD, D, H, E = 5, 16, 7, 8, 10


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _case(seed=7):
    """(JAX model, module, params; port model, module with the same
    params), the vocabulary built from ``TARGETS``."""
    kw = dict(max_seq_len=6, hidden_size=H, embedding_size=E, memories_hidden_dim=D,
              vocabulary_count_threshold=1, dropout_rate=0.0)
    jmodel, tmodel = JaxDecoderModel(**kw), GruCopyingDecoderModel(**kw)
    jmodel.compute_metadata(iter([JaxDecoderData(i, t) for i, t in zip(INPUTS, TARGETS)]), parallelize=False)
    tmodel.compute_metadata(iter([DecoderData(i, t) for i, t in zip(INPUTS, TARGETS)]), parallelize=False)
    assert tmodel.vocabulary.id_to_token == jmodel.vocabulary.id_to_token
    jmodule, tmodule = jmodel.build_neural_module(), tmodel.build_neural_module()
    params = jax.tree_util.tree_map(np.asarray, jmodule.init(jax.random.PRNGKey(seed)))
    tmodule.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()})
    return jmodel, jmodule, params, tmodel, tmodule


def _memories(seed=5, scale=1.0):
    """Padded memories, their origins (padding: B_PAD), mask and initial
    states, as numpy."""
    rng = np.random.RandomState(seed)
    counts = [len(i) for i in INPUTS]
    m_real = sum(counts)
    mem = np.zeros((M_PAD, D), np.float32)
    mem[:m_real] = rng.randn(m_real, D) * scale
    origin = np.full(M_PAD, B_PAD, np.int32)
    origin[:m_real] = np.concatenate([[b] * c for b, c in enumerate(counts)])
    mask = np.arange(M_PAD) < m_real
    init = np.zeros((B_PAD, H), np.float32)
    init[: len(INPUTS)] = rng.randn(len(INPUTS), H) * scale
    return mem, origin, mask, init


def _finalized(jmodel, tmodel, targets):
    """Both models' finalized decoder minibatches of ``targets``."""
    out = []
    for model, cls in ((jmodel, JaxDecoderData), (tmodel, DecoderData)):
        mb = model.initialize_minibatch()
        for i, t in zip(INPUTS, targets):
            model.extend_minibatch_with(model.tensorize(cls(i, t)), mb)
        out.append(model.finalize_minibatch(mb, max_targets=B_PAD, memories_budget=M_PAD))
    return out


def _assert_grads(tmodule, jgrads):
    flat = _flat(jgrads)
    names = [n for n, _ in tmodule.named_parameters()]
    assert sorted(names) == sorted(flat)
    for name, p in tmodule.named_parameters():
        want = flat[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max() + 1e-30,
                                   err_msg=name)


def test_gru_matches_jax():
    jgru = JaxGRU(6, 9)
    params = jax.tree_util.tree_map(np.asarray, jgru.init(jax.random.PRNGKey(2)))
    gru = GRU(6, 9)
    gru.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in params.items()})
    rng = np.random.RandomState(0)
    x, h0 = rng.randn(4, 5, 6).astype(np.float32), rng.randn(4, 9).astype(np.float32)
    cot_y, cot_h = rng.randn(4, 5, 9).astype(np.float32), rng.randn(4, 9).astype(np.float32)

    def f(p, x, h0):
        ys, h = jgru.apply(p, x, h0)
        return jnp.sum(ys * cot_y) + jnp.sum(h * cot_h)

    jys, jh = jgru.apply(params, jnp.asarray(x), jnp.asarray(h0))
    jgrads = jax.grad(f, argnums=(0, 1, 2))(params, jnp.asarray(x), jnp.asarray(h0))
    tx, th = torch.from_numpy(x).requires_grad_(), torch.from_numpy(h0).requires_grad_()
    ys, h = gru(tx, th)
    ((ys * torch.from_numpy(cot_y)).sum() + (h * torch.from_numpy(cot_h)).sum()).backward()
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrads[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgrads[2]), rtol=1e-5, atol=1e-5)
    for name, p in gru.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[0][name]), rtol=1e-5, atol=1e-5,
                                   err_msg=name)


def test_compute_logprobs_matches_jax():
    """Both outputs and the final state, and the gradients of a random
    projection of them through every parameter, the memories and the
    initial states."""
    _, jmodule, params, _, tmodule = _case()
    mem, origin, mask, init = _memories()
    tokens = np.random.RandomState(3).randint(0, jmodule.vocabulary_size, (B_PAD, 4)).astype(np.int32)
    rng = np.random.RandomState(4)
    cots = (rng.randn(M_PAD, 4), rng.randn(B_PAD, 4, jmodule.vocabulary_size), rng.randn(B_PAD, H))
    cots = [c.astype(np.float32) for c in cots]

    def f(p, mem, init):
        outs = jmodule._compute_logprobs(p, init, mem, jnp.asarray(origin), jnp.asarray(mask), jnp.asarray(tokens))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, jouts), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(mem), jnp.asarray(init))
    tmem, tinit = torch.from_numpy(mem).requires_grad_(), torch.from_numpy(init).requires_grad_()
    touts = tmodule.compute_logprobs(tinit, tmem, torch.from_numpy(origin), torch.from_numpy(mask),
                                     torch.from_numpy(tokens))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cots)).backward()
    for got, want in zip(touts, jouts):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    _assert_grads(tmodule, jgrads[0])
    for got, want in ((tmem.grad, jgrads[1]), (tinit.grad, jgrads[2])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def _loss_pair(targets=TARGETS, scale=1.0, unk_id=None):
    """(JAX loss, JAX param gradients, port loss, port module after its
    backward) on the same inputs."""
    jmodel, jmodule, params, tmodel, tmodule = _case()
    if unk_id is not None:
        jmodule.unk_id = tmodule.unk_id = unk_id
    jfin, tfin = _finalized(jmodel, tmodel, targets)
    for k in ("target_token_ids", "target_lengths", "copy_matrix"):
        np.testing.assert_array_equal(tfin[k], jfin[k], err_msg=k)
    mem, origin, mask, init = _memories(scale=scale)
    arrays = dict(input_memories=mem, input_memories_origin_idx=origin, memory_mask=mask, initial_states=init)

    def f(p):
        return jmodule.apply(p, **{k: jnp.asarray(v) for k, v in {**arrays, **jfin}.items()})

    (jloss, jmetrics), jgrads = jax.value_and_grad(f, has_aux=True)(params)
    tloss, tmetrics = tmodule(**{k: torch.from_numpy(np.asarray(v)) for k, v in {**arrays, **tfin}.items()})
    tloss.backward()
    assert int(tmetrics["num_sequences"]) == int(jmetrics["num_sequences"]) == 3
    return float(jloss), jgrads, float(tloss.detach()), tmodule


def test_loss_and_gradients_match_jax():
    jloss, jgrads, tloss, tmodule = _loss_pair()
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_grads(tmodule, jgrads)


def test_unk_generation_blocked_where_a_copy_exists():
    """"epsilon" is out of the vocabulary (UNK) but copyable from sample 2's
    memories: its UNK generation is blocked, as in JAX. Without the block
    (no id is UNK) the loss differs."""
    targets = TARGETS[:2] + [["epsilon"]]
    jloss, jgrads, tloss, tmodule = _loss_pair(targets)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_grads(tmodule, jgrads)
    unblocked = _loss_pair(targets, unk_id=-1)
    np.testing.assert_allclose(unblocked[2], unblocked[0], rtol=1e-5)
    assert abs(unblocked[2] - tloss) > 1e-3


def test_loss_finite_when_copy_score_dominates():
    """Inputs 300 times larger: the total copy score exceeds every vocabulary
    score by far more than 88. The normaliser's shift takes it, so the loss
    and every gradient stay finite (and equal JAX's)."""
    jloss, jgrads, tloss, tmodule = _loss_pair(scale=300.0)
    assert np.isfinite(tloss)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for name, p in tmodule.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), name
    _assert_grads(tmodule, jgrads)


def _decode_inputs(tmodel):
    mem, origin, mask, init = _memories()
    return dict(
        input_concrete_values=[v for inp in INPUTS for v in inp],
        input_memories=torch.from_numpy(mem),
        input_memories_origin_idx=torch.from_numpy(origin),
        memory_mask=torch.from_numpy(mask),
        initial_states=torch.from_numpy(init),
        num_real_targets=len(INPUTS),
    )


def _jax_kwargs(tkw, params, jmodule):
    out = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v) for k, v in tkw.items()}
    return dict(out, params=params, neural_module=jmodule)


def test_copy_groups_bitwise():
    jmodel, jmodule, _, tmodel, tmodule = _case()
    mem, origin, mask, _ = _memories()
    values = [v for inp in INPUTS for v in inp]
    for batch_size in (3, 2):
        got = tmodel._build_copy_groups(values, origin, mask, batch_size, B_PAD, tmodule.unk_id)
        want = jmodel._build_copy_groups(values, jnp.asarray(origin), jnp.asarray(mask), batch_size, B_PAD,
                                         jmodule.unk_id)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w


def test_greedy_decode_device_host_and_jax_agree():
    """The device loop, the host loop (merging over the whole vocabulary)
    and JAX's device loop: the same tokens, log-probabilities to 1e-5."""
    jmodel, jmodule, params, tmodel, tmodule = _case()
    tkw = _decode_inputs(tmodel)
    device = tmodel.greedy_decode(**tkw, neural_module=tmodule)
    host = tmodel.greedy_decode(**tkw, neural_module=tmodule, device_resident=False, top_k=tmodule.vocabulary_size)
    jax_dev = jmodel.greedy_decode(**_jax_kwargs(tkw, params, jmodule))
    assert len(device) == len(host) == len(jax_dev) == 3
    for (d_toks, d_lp), (h_toks, h_lp), (j_toks, j_lp) in zip(device, host, jax_dev):
        assert d_toks == h_toks == j_toks
        np.testing.assert_allclose([d_lp, h_lp], [j_lp, j_lp], rtol=1e-5, atol=1e-5)


def test_temperature_sampling():
    """A near-zero temperature reproduces greedy; one generator seed gives
    one sample; the log-probabilities are those of real actions."""
    _, _, _, tmodel, tmodule = _case()
    tkw = _decode_inputs(tmodel)
    greedy = tmodel.greedy_decode(**tkw, neural_module=tmodule)
    cold = tmodel.greedy_decode(**tkw, neural_module=tmodule, temperature=1e-6,
                                generator=torch.Generator().manual_seed(0))
    assert [t for t, _ in cold] == [t for t, _ in greedy]
    np.testing.assert_allclose([lp for _, lp in cold], [lp for _, lp in greedy], rtol=1e-5, atol=1e-5)
    s1, s2 = (tmodel.greedy_decode(**tkw, neural_module=tmodule, temperature=1.0,
                                   generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert s1 == s2
    assert all(np.isfinite(lp) and lp <= 1e-6 for _, lp in s1)
    with pytest.raises(ValueError):
        tmodel.greedy_decode(**tkw, neural_module=tmodule, temperature=1.0)


@pytest.mark.parametrize("beam_size", [1, 4])
def test_beam_decode_matches_jax(beam_size):
    """Beams sorted best first, distinct, the top one no worse than greedy;
    beam 1 is greedy; tokens equal JAX's, scores to 1e-5."""
    jmodel, jmodule, params, tmodel, tmodule = _case()
    tkw = _decode_inputs(tmodel)
    greedy = tmodel.greedy_decode(**tkw, neural_module=tmodule)
    beams = tmodel.beam_decode(beam_size=beam_size, **tkw, neural_module=tmodule)
    jbeams = jmodel.beam_decode(beam_size=beam_size, **_jax_kwargs(tkw, params, jmodule))
    assert len(beams) == 3
    for (g_toks, g_lp), got, want in zip(greedy, beams, jbeams):
        assert [t for t, _ in got] == [t for t, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5, atol=1e-5)
        scores = [s for _, s in got]
        assert scores == sorted(scores, reverse=True)
        assert scores[0] >= g_lp - 1e-4
        seqs = [tuple(t) for t, s in got if np.isfinite(s)]
        assert len(set(seqs)) == len(seqs)
        if beam_size == 1:
            assert got[0][0] == g_toks
            np.testing.assert_allclose(got[0][1], g_lp, rtol=1e-5, atol=1e-5)


def test_beam_decode_breaks_planted_ties_as_jax():
    """Every weight that scores a candidate is zero: each step's candidates
    of a sample tie exactly, and the selection keeps the lower (beam,
    candidate) index first, as jax.lax.top_k does."""
    jmodel, jmodule, params, tmodel, tmodule = _case()
    for key in ("hidden_to_vocab", "vocab_bias"):
        params[key] = np.zeros_like(params[key])
    params["mem_to_copy"]["weight"] = np.zeros_like(params["mem_to_copy"]["weight"])
    with torch.no_grad():
        for p in (tmodule.hidden_to_vocab, tmodule.vocab_bias, tmodule.mem_to_copy.weight):
            p.zero_()
    tkw = _decode_inputs(tmodel)
    beams = tmodel.beam_decode(beam_size=3, **tkw, neural_module=tmodule)
    jbeams = jmodel.beam_decode(beam_size=3, **_jax_kwargs(tkw, params, jmodule))
    for got, want in zip(beams, jbeams):
        assert [t for t, _ in got] == [t for t, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-6)
        assert len({s for _, s in got}) < len(got)  # the scores do tie


def test_greedy_decode_copies_after_overfitting():
    """Trained on the three targets, the decoder copies them back, the
    out-of-vocabulary one included."""
    jmodel, _, _, tmodel, tmodule = _case()
    _, tfin = _finalized(jmodel, tmodel, TARGETS)
    tkw = _decode_inputs(tmodel)
    batch = {k: torch.from_numpy(v) for k, v in tfin.items()}
    optimizer = torch.optim.Adam(tmodule.parameters(), lr=5e-2)
    memory_kw = {k: tkw[k] for k in ("input_memories", "input_memories_origin_idx", "memory_mask", "initial_states")}
    for _ in range(150):
        loss, _ = tmodule(**memory_kw, **batch)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad()
    assert float(loss.detach()) < 0.5
    decoded = tmodel.greedy_decode(**tkw, neural_module=tmodule)
    assert decoded[0][0] == ["alpha", "beta"]


def test_luong_attention_matches_jax():
    jatt = JaxLuong(6, 5, 4)
    params = jax.tree_util.tree_map(np.asarray, jatt.init(jax.random.PRNGKey(1)))
    att = LuongAttentionModule(6, 5, 4)
    att.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in _flat(params).items()})
    rng = np.random.RandomState(0)
    memories = rng.randn(3, 7, 6).astype(np.float32)
    lengths = np.array([7, 3, 1], np.int32)
    lookups = rng.randn(3, 2, 5).astype(np.float32)
    cot = rng.randn(3, 2, 4).astype(np.float32)

    def f(p, mem, look):
        out = jatt.apply(p, memories=mem, memories_length=jnp.asarray(lengths), lookup_vectors=look)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        params, jnp.asarray(memories), jnp.asarray(lookups))
    tmem, tlook = torch.from_numpy(memories).requires_grad_(), torch.from_numpy(lookups).requires_grad_()
    out = att(memories=tmem, memories_length=torch.from_numpy(lengths), lookup_vectors=tlook)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    _assert_grads(att, jgrads[0])
    for got, want in ((tmem.grad, jgrads[1]), (tlook.grad, jgrads[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4 * np.abs(want).max())
