"""The port's node-embedder options against the JAX package's: the byte-pair
encoding (merges, ranks and ids bitwise, on the JAX embedder tests' words
and on a seeded identifier corpus full of tied pair counts), the ``bpe``
splitting's lifecycle (finalized arrays bitwise), and the subtoken
embedder's sum, mean and max pooling with and without the dense output on
converted weights, forward and gradients, on rows with repeated subtokens
(exact ties in the max) and rows of length 0.

Tolerances, float32: forward rtol 1e-6, atol 1e-6; gradients within 1e-6 of
their largest magnitude (the same sums, added in another order)."""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptgnn_tpu.graph.embedders import StrElementRepresentationModel as JaxStrModel
from ptgnn_tpu.graph.embedders import SubtokenUnitEmbedder as JaxSubtokenUnitEmbedder
from ptgnn_tpu.utils.text import BpeVocabulary as JaxBpeVocabulary
from ptgnn_tpu_torch.graph.embedders import StrElementRepresentationModel, SubtokenUnitEmbedder
from ptgnn_tpu_torch.utils.text import BpeVocabulary

WORDS = [
    "getValue", "set_item", "maxCount", "numNodes", "fileName", "toString",
    "parseInt", "loadData", "saveFile", "runLoop", "batchSize", "learnRate",
] * 5


def identifier_corpus(seed, n=300):
    """Identifiers over a small alphabet with small counts: many pairs tie."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdeXY_1"))
    words = ["".join(rng.choice(letters, size=rng.randint(1, 9))) for _ in range(n)]
    words += ["getGet", "getget", "aaaa", ""]
    return words


def vocab_pair(counter, max_size):
    jv, tv = JaxBpeVocabulary(max_size), BpeVocabulary(max_size)
    jv.create_vocabulary(counter)
    tv.create_vocabulary(counter)
    return jv, tv


@pytest.mark.parametrize("corpus", ["words", "identifiers0", "identifiers1", "identifiers2"])
@pytest.mark.parametrize("max_size", [16, 64, 400])
def test_bpe_merges_and_ids_bitwise(corpus, max_size):
    words = WORDS if corpus == "words" else identifier_corpus(int(corpus[-1]))
    counter = Counter(words)
    jv, tv = vocab_pair(counter, max_size)
    jmerges = jv._BpeVocabulary__merges
    tmerges = tv._BpeVocabulary__merges
    assert list(tmerges.items()) == list(jmerges.items())
    assert tv._BpeVocabulary__vocab.id_to_token == jv._BpeVocabulary__vocab.id_to_token
    assert len(tv) == len(jv)
    probes = list(counter) + ["zzzzqqqq", "getValueX", "<empty>", "a", "ab1_"]
    for word in probes:
        assert tv.tokenize(word) == jv.tokenize(word), word
        assert tv.get_id_or_unk_for_text(word) == jv.get_id_or_unk_for_text(word), word


def test_bpe_ties_decide_merges_by_insertion_order():
    """Tied pair counts: the first pair met in the words' order wins, on both
    sides, and reordering the corpus changes the merges on both alike."""
    counter = Counter({"ab": 2, "cd": 2, "ef": 2})
    reordered = Counter({"ef": 2, "cd": 2, "ab": 2})
    for c in (counter, reordered):
        jv, tv = vocab_pair(c, 12)
        assert list(tv._BpeVocabulary__merges) == list(jv._BpeVocabulary__merges)
    first = list(vocab_pair(counter, 12)[1]._BpeVocabulary__merges)[0]
    first_reordered = list(vocab_pair(reordered, 12)[1]._BpeVocabulary__merges)[0]
    assert first == ("a", "b") and first_reordered == ("e", "f")


def _str_models(**kw):
    return JaxStrModel(**kw), StrElementRepresentationModel(**kw)


@pytest.mark.parametrize("combination", ["sum", "mean", "max"])
def test_bpe_lifecycle_finalized_arrays_bitwise(combination):
    kw = dict(token_splitting="bpe", embedding_size=16, vocabulary_size=64, min_freq_threshold=1,
              dropout_rate=0.0, max_num_subtokens=4, subtoken_combination=combination)
    jm, tm = _str_models(**kw)
    jm.compute_metadata(iter(WORDS), parallelize=False)
    tm.compute_metadata(iter(WORDS), parallelize=False)
    assert len(tm.vocabulary) == len(jm.vocabulary)
    probes = WORDS[:10] + ["", "zzzzqqqq"]
    jmb, tmb = jm.initialize_minibatch(), tm.initialize_minibatch()
    for w in probes:
        jt, js = jm.tensorize(w, return_str_rep=True)
        tt, ts = tm.tensorize(w, return_str_rep=True)
        assert tt == jt and ts == js
        assert tm.tensorize(w) == jm.tensorize(w)
        jm.extend_minibatch_with(jt, jmb)
        tm.extend_minibatch_with(tt, tmb)
    jdata = jm.finalize_minibatch(jmb, pad_to=16)
    tdata = tm.finalize_minibatch(tmb, pad_to=16)
    assert set(tdata) == set(jdata) == {"token_idxs", "lengths"}
    for key in jdata:
        assert tdata[key].dtype == jdata[key].dtype and tdata[key].shape == jdata[key].shape
        np.testing.assert_array_equal(tdata[key], jdata[key])
    assert tm.tensorize("", return_str_rep=True)[1] == jm.vocabulary.tokenize("<empty>")
    module = tm.build_neural_module()
    assert isinstance(module, SubtokenUnitEmbedder) and module.combination == combination


def _subtoken_inputs(seed, vocab=11, width=4, rows=12):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, size=(rows, width)).astype(np.int32)
    lengths = rng.randint(0, width + 1, size=rows).astype(np.int32)
    ids[0] = [3, 3, 5, 0]  # "getGet": a repeated subtoken, exact ties in the max
    lengths[0] = 2
    ids[1] = [7, 7, 7, 7]
    lengths[1] = 4
    lengths[2] = 0  # a padding row
    lengths[3] = 0
    return ids, lengths


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "no_dense"])
@pytest.mark.parametrize("combination", ["sum", "mean", "max"])
def test_subtoken_embedder_matches_jax(combination, dense):
    vocab, d = 11, 6
    jlayer = JaxSubtokenUnitEmbedder(vocab, d, 0.0, combination, use_dense_output=dense)
    tlayer = SubtokenUnitEmbedder(vocab, d, 0.0, combination, use_dense_output=dense)
    params = jax.tree_util.tree_map(np.asarray, jlayer.init(jax.random.PRNGKey(3)))
    state = {"embeddings.weight": torch.from_numpy(params["embeddings"]["weight"].copy())}
    if dense:
        state["out_layer.weight"] = torch.from_numpy(params["out_layer"]["weight"].copy())
    assert ("out_layer" in params) == dense
    tlayer.load_state_dict(state, strict=True)

    ids, lengths = _subtoken_inputs(0, vocab)
    cot = np.random.RandomState(1).randn(ids.shape[0], d).astype(np.float32)

    def jloss(p):
        out = jlayer.apply(p, jnp.asarray(ids), jnp.asarray(lengths))
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    tout = tlayer(torch.from_numpy(ids), torch.from_numpy(lengths))
    (tout * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    assert np.isfinite(tout.detach().numpy()).all()
    np.testing.assert_array_equal(tout.detach().numpy()[2:4], 0.0 * tout.detach().numpy()[2:4])
    pairs = [("embeddings.weight", jgrads["embeddings"]["weight"])]
    if dense:
        pairs.append(("out_layer.weight", jgrads["out_layer"]["weight"]))
    named = dict(tlayer.named_parameters())
    for name, want in pairs:
        got = named[name].grad.numpy()
        want = np.asarray(want)
        assert np.isfinite(got).all() and np.isfinite(want).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(np.abs(want).max(), 1e-30), err_msg=name)
    if combination == "max":
        # The tied row splits its gradient evenly: id 7 fills all of row 1,
        # so its embedding row's gradient is row 1's upstream gradient
        # (through the dense layer) once, shared four ways.
        assert np.abs(named["embeddings.weight"].grad.numpy()[7]).sum() > 0


def test_str_model_rejects_unknown_splitting_and_combination():
    with pytest.raises(ValueError, match="splitting"):
        StrElementRepresentationModel(token_splitting="words")
    with pytest.raises(ValueError, match="combination"):
        SubtokenUnitEmbedder(4, 4, 0.0, "median")
