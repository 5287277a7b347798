"""Load the JAX package's task-model parameters (Graph2Class, PPI,
VarMisuse, Graph2Seq) into the port's module.

The JAX params are nested dicts and lists of numpy arrays:

    {"gnn": {"node_embedder": {...}, "mp_layers": [<one per unique layer>]},
     <head>: {"weight": [C, H], "bias": [C]}}

with the head ``node_to_class`` (Graph2Class), ``to_logits`` (PPI) or
``candidate_scores`` (VarMisuse), the name of the port module's attribute
too; Graph2Seq has two heads, ``decoder`` and ``summarizer``. VarMisuse's
char CNN is ``node_embedder.embedder.conv{1,2,3}.{weight, bias}`` (``[out,
in, k]``; conv3 has no bias), and a global update's entry
holds ``summary`` (the reduce's params, e.g. ``weights.weight``) and
``update`` (its GRU cell); the port's modules use these names.
Graph2Seq's node embedder is ``node_embedder.embeddings.weight`` ``[V, D]``.
A GNN with edge features holds its edge embedder under ``gnn.edge_embedder``
(a feature embedder: ``linear.weight`` ``[F, F_in]``), the port module's
``gnn.edge_feature_embedder``; the layers that read the features have their
first message weights widened by F (an MLP-MP layer's ``weights_0`` ``[T,
d_in + F, d_out]``, a gated layer's ``message_weights`` ``[T, D + F, M]``).
Its ``decoder`` holds ``embedding.weight`` ``[V_out, E]``, ``gru`` (the GRU
cell's four arrays, as a gated layer's ``state_update``: ``weight_ih``
``[3H, E]``), ``mem_to_std.weight`` and ``mem_to_copy.weight`` ``[H, D]``,
and two raw arrays, ``hidden_to_vocab`` ``[2H, E]`` and ``vocab_bias``
``[V_out]``. Its ``summarizer`` (the multi-head self-attention reduce) holds
``key.weight`` ``[2D, 2D]`` and ``output.weight`` ``[D, 2D x heads]``; the
nested ``query`` summariser has no params (``{}``). TypedMLP ``weights_0`` is
``[T, d_in, d_out]`` and every Linear ``weight`` ``[out, in]`` (PPI's
embedder: ``node_embedder.linear.weight`` ``[H, F]``): the port's layouts,
so each array loads as is. The gated (GGNN) layer's ``message_weights`` is
``[T, D, M]`` and its ``state_update`` holds the GRU cell's ``weight_ih``
``[3H, M]``, ``weight_hh`` ``[3H, H]``, ``bias_ih`` and ``bias_hh``
``[3H]``, under the same names in the port. The other layers' entries
load under their JAX names too: an MLP-MP layer's ``message_mlp`` holds
``weights_{i}`` ``[T, d_in, d_out]`` (one per MLP layer), beside
``layer_norm`` and ``dense`` where the layer has them, and an
``aggregation`` entry that is ``{}`` for PNA; EGC holds ``bases`` ``[T, D,
B x O]`` and ``weight_coeffs`` (a Linear); GraphNorm ``gamma``, ``alpha``
and ``bias``, each ``[1, D]``; self-attention ``head_transforms`` and
``summarization`` (bias-free Linears), ``intermediate`` and ``output``
(Linears), ``layer_norm1`` and ``layer_norm2``. An ``MLP`` holds
``layer_{i}`` Linears. ``mp_layers`` holds one entry
per unique layer object, in stack order; a layer object used at several
positions (the GGNN stack's shared layer) loads its one entry at each of
them, and residual entries are ``{}`` and map to nothing. A JAX key without
a counterpart raises here; a port parameter that no JAX key fills raises in
``load_state_dict``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(prefix: str, tree: Any, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(f"{prefix}{k}.", v, out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def jax_params_to_state_dict(module: torch.nn.Module, params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict for the JAX params pytree."""
    flat: Dict[str, np.ndarray] = {}
    _flatten("gnn.node_embedder.", params["gnn"]["node_embedder"], flat)
    if "edge_embedder" in params["gnn"]:
        _flatten("gnn.edge_feature_embedder.", params["gnn"]["edge_embedder"], flat)
    for head, tree in params.items():
        if head != "gnn":
            _flatten(f"{head}.", tree, flat)
    layer_params = params["gnn"]["mp_layers"]
    for position, unique in enumerate(module.gnn._layer_param_index):
        _flatten(f"gnn.message_passing_layers.{position}.", layer_params[unique], flat)
    expected = module.state_dict()
    state = {}
    for key, value in flat.items():
        if key not in expected:
            raise KeyError(f"JAX parameter {key} has no counterpart in the port's module")
        if tuple(value.shape) != tuple(expected[key].shape):
            raise ValueError(f"{key}: JAX shape {value.shape}, port shape {tuple(expected[key].shape)}")
        state[key] = torch.from_numpy(np.array(value)).to(expected[key].dtype)  # a writable copy
    return state


@torch.no_grad()
def load_jax_params(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy the JAX params into ``module`` (every parameter must be given)."""
    module.load_state_dict(jax_params_to_state_dict(module, params), strict=True)
    return module
