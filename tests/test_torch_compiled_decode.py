"""The compiled Graph2Seq decode loops (``sequence/grucopydecoder.py``'s
``decode_loop``: a ``core/compiled_step.py`` step per loop, module and
generator) on the CPU, where a compiled step is a plain call, against the
loops called directly and against the JAX package's decodes on the same
converted weights (the decoder cases of ``test_torch_copydecoder.py``):

* greedy, Gumbel-max sampling (a reseeded generator) and beam loops
  through the compiled step equal the direct calls bit for bit;
* the greedy and beam decodes equal JAX's ``greedy_decode`` and
  ``beam_decode``, and sampling at temperature 1e-6 JAX's greedy one:
  tokens exactly, log-probabilities within 1e-5 (the tolerance of
  ``test_torch_copydecoder.py``); JAX's random bits cannot be reproduced,
  so a warm sample is held only to the direct call;
* the signature of a loop call is one key for each (b_pad, m_pad, g_pad,
  beams, sampling or not): the same key for batches of one budget, another
  when the group budget (a power of two) or the beam count changes; the
  model keeps one compiled loop per (kind, module, generator) and pickles
  without them.
"""
import pickle

import numpy as np
import pytest
import torch

from ptgnn_tpu_torch.core.compiled_step import CompiledStep, signature
from tests.test_torch_copydecoder import INPUTS, _case, _decode_inputs, _jax_kwargs


def _groups(tmodel, tmodule, tkw, k, values=None):
    values = tkw["input_concrete_values"] if values is None else values
    b_pad = tkw["initial_states"].shape[0]
    return tmodel._copy_groups(k, values, tkw["input_memories"], tkw["input_memories_origin_idx"],
                               tkw["memory_mask"], tkw["num_real_targets"], b_pad, tmodule.vocabulary_size,
                               tmodule.unk_id)[0]


@pytest.mark.parametrize("kind", ["greedy", "sampled", "beam"])
def test_compiled_loops_equal_direct_calls_bitwise(kind):
    _, _, _, tmodel, tmodule = _case()
    tkw = _decode_inputs(tmodel)
    generator = torch.Generator()
    loop = tmodel.decode_loop("beam" if kind == "beam" else "greedy", tmodule, torch.device("cpu"),
                              generator if kind == "sampled" else None)
    assert isinstance(loop, CompiledStep)
    k = 3 if kind == "beam" else 1
    groups = _groups(tmodel, tmodule, tkw, k)
    extra = (k,) if kind == "beam" else (torch.tensor(0.8) if kind == "sampled" else None,)
    for seed in (1, 2, 1):
        generator.manual_seed(seed)
        got = loop(groups, tkw["initial_states"], *extra)
        generator.manual_seed(seed)
        want = loop.fn(groups, tkw["initial_states"], *extra)
        assert len(got) == len(want) == (3 if kind == "beam" else 2)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (kind, seed)


def test_compiled_greedy_and_cold_sampling_equal_jax():
    jmodel, jmodule, params, tmodel, tmodule = _case()
    tkw = _decode_inputs(tmodel)
    want = jmodel.greedy_decode(**_jax_kwargs(tkw, params, jmodule))
    greedy = tmodel.greedy_decode(**tkw, neural_module=tmodule)
    cold = tmodel.greedy_decode(**tkw, neural_module=tmodule, temperature=1e-6,
                                generator=torch.Generator().manual_seed(4))
    for got in (greedy, cold):
        assert [t for t, _ in got] == [t for t, _ in want]
        np.testing.assert_allclose([lp for _, lp in got], [lp for _, lp in want], rtol=1e-5, atol=1e-5)
    # a warm sample: the same draws from the same seed, through the model
    warm = [tmodel.greedy_decode(**tkw, neural_module=tmodule, temperature=1.0,
                                 generator=torch.Generator().manual_seed(6)) for _ in range(2)]
    assert warm[0] == warm[1]


@pytest.mark.parametrize("beam_size", [1, 3])
def test_compiled_beam_decode_equals_jax(beam_size):
    jmodel, jmodule, params, tmodel, tmodule = _case()
    tkw = _decode_inputs(tmodel)
    beams = tmodel.beam_decode(beam_size=beam_size, **tkw, neural_module=tmodule)
    jbeams = jmodel.beam_decode(beam_size=beam_size, **_jax_kwargs(tkw, params, jmodule))
    assert len(beams) == len(jbeams) == len(INPUTS)
    for got, want in zip(beams, jbeams):
        assert [t for t, _ in got] == [t for t, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-5, atol=1e-5)


def test_signatures_follow_the_budgets_and_the_model_keeps_one_loop_each():
    _, _, _, tmodel, tmodule = _case()
    tkw = _decode_inputs(tmodel)
    states = tkw["initial_states"]

    def key(groups, *extra):
        return signature((groups, states, *extra), {})[0]

    base = _groups(tmodel, tmodule, tkw, 1)
    # other strings, the same number of groups per sample: the same budget
    renamed = [f"{v}_x" for v in tkw["input_concrete_values"]]
    same = _groups(tmodel, tmodule, tkw, 1, renamed)
    assert same.g_pad == base.g_pad and key(same, None) == key(base, None)
    # every memory its own string: more groups, the next power of two
    distinct = [f"s{i}" for i in range(len(renamed))]
    wider = _groups(tmodel, tmodule, tkw, 1, distinct)
    assert wider.g_pad > base.g_pad and wider.g_pad & (wider.g_pad - 1) == 0
    assert key(wider, None) != key(base, None)
    # sampling (a temperature input) and the beam count are part of it too
    assert key(base, torch.tensor(1.0)) != key(base, None)
    assert key(_groups(tmodel, tmodule, tkw, 3), 3) != key(_groups(tmodel, tmodule, tkw, 2), 2)

    cpu = torch.device("cpu")
    generator = torch.Generator()
    greedy = tmodel.decode_loop("greedy", tmodule, cpu)
    assert tmodel.decode_loop("greedy", tmodule, cpu) is greedy
    assert tmodel.decode_loop("greedy", tmodule, cpu, generator) is not greedy
    assert tmodel.decode_loop("beam", tmodule, cpu) is not greedy
    _, other = _case()[3:]
    assert tmodel.decode_loop("greedy", other, cpu) is not greedy
    with pytest.raises(ValueError):
        tmodel.decode_loop("topk", tmodule, cpu)
    restored = pickle.loads(pickle.dumps(tmodel))
    assert "_decode_loops_compiled_cache" not in restored.__dict__
    assert restored.greedy_decode(**tkw, neural_module=tmodule) == tmodel.greedy_decode(**tkw, neural_module=tmodule)
