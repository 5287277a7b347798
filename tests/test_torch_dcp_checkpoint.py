"""Async sharded checkpoints on torch.distributed.checkpoint
(``ptgnn_tpu_torch/core/dcp_checkpoint.py``), the counterpart of the JAX
package's ``OrbaxCheckpointer`` (``tests/test_orbax_checkpoint.py``).

* One process: a round trip of the parameters, the Adam state and its
  hyperparameters, and the model sidecar; an async save that the caller
  steps past holds the state of its call; retention evicts the oldest steps
  and their sidecars; remote paths raise.
* Two gloo ranks under ZeRO-1 (one spawned world, ``tests/torch_shard_worker.py``):
  each rank's files hold only its own partition of the optimizer state; a
  restore at world 2 equals the consolidated state at the save, and its
  step 4 equals the uninterrupted step 4 bit for bit; a restore at world 1
  (this process, a plain Adam) equals the consolidated state too.

Everything is compared bitwise: a checkpoint copies bits."""
from pathlib import Path

import pytest
import torch

from ptgnn_tpu_torch.core.dcp_checkpoint import DistributedCheckpointer
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from tests.torch_shard_worker import launch

KW = dict(num_metadata_graphs=32, mean_nodes=30, max_graph_nodes=80, hidden_state_size=32, num_minibatches=4,
          minibatch_size=4, dropout_rate=0.0)


def _small_module():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(), torch.nn.Linear(5, 3))


def _adam_step(module, optimizer, seed):
    g = torch.Generator().manual_seed(seed)
    optimizer.zero_grad()
    module(torch.randn(7, 6, generator=g)).square().sum().backward()
    optimizer.step()


def _snapshot(module, optimizer):
    return ({k: v.clone() for k, v in module.state_dict().items()},
            {i: {k: v.clone() for k, v in st.items()} for i, st in optimizer.state_dict()["state"].items()})


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_bitwise(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_round_trip_async_save_retention_and_sidecars(tmp_path):
    module = _small_module()
    optimizer = torch.optim.Adam(module.parameters(), lr=1e-2, betas=(0.8, 0.95))
    ckpt = DistributedCheckpointer(tmp_path / "ckpt", max_to_keep=2)
    snapshots = {}
    for step in (1, 2, 3):
        _adam_step(module, optimizer, step)
        snapshots[step] = _snapshot(module, optimizer)
        ckpt.save(step, module, optimizer, model={"step": step})
        _adam_step(module, optimizer, 100 + step)  # steps on while the save is in flight
    ckpt.wait()
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2", "2.model.pkl.gz", "3", "3.model.pkl.gz"]

    for step in (None, 2):
        fresh = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(), torch.nn.Linear(5, 3))
        fresh_optimizer = torch.optim.Adam(fresh.parameters(), lr=0.5)
        assert ckpt.restore(step, module=fresh, optimizer=fresh_optimizer) == (step or 3)
        want_params, want_state = snapshots[step or 3]
        got_params, got_state = _snapshot(fresh, fresh_optimizer)
        _assert_bitwise(got_params, want_params)
        _assert_bitwise(got_state, want_state)
        group = fresh_optimizer.param_groups[0]
        assert group["lr"] == 1e-2 and tuple(group["betas"]) == (0.8, 0.95)
        assert ckpt.restore_model(step) == {"step": step or 3}
    # a restored optimizer steps as the original did from the same state
    fresh = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(), torch.nn.Linear(5, 3))
    fresh_optimizer = torch.optim.Adam(fresh.parameters())
    ckpt.restore(3, module=fresh, optimizer=fresh_optimizer)
    _adam_step(fresh, fresh_optimizer, 103)
    _assert_bitwise(fresh.state_dict(), module.state_dict())
    # parameters alone: a restore without the optimizer
    bare = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(), torch.nn.Linear(5, 3))
    ckpt.restore(2, module=bare)
    _assert_bitwise(bare.state_dict(), snapshots[2][0])

    ckpt.save(4, module, model={"step": 4}, wait=True)
    assert ckpt.all_steps() == [3, 4]
    assert not (tmp_path / "ckpt" / "2.model.pkl.gz").exists()
    with pytest.raises(KeyError):
        ckpt.restore(4, module=bare, optimizer=torch.optim.Adam(bare.parameters()))
    ckpt.close()


def test_remote_paths_and_empty_directories_raise(tmp_path):
    with pytest.raises(ValueError):
        DistributedCheckpointer("gs://bucket/ckpt")
    with pytest.raises(FileNotFoundError):
        DistributedCheckpointer(tmp_path / "empty").restore(module=_small_module())


@pytest.fixture(scope="module")
def zero1_world(tmp_path_factory):
    model, module, minibatches = build_graph2class(padding=small_padding(max_nodes=256, max_graphs=8), device="cpu",
                                                   **KW)
    payload = {"model": model, "state": {k: v.clone() for k, v in module.state_dict().items()},
               "minibatches": minibatches}
    tmp = tmp_path_factory.mktemp("dcp_world")
    (ranks,) = zip(*launch([("dcp_zero1", payload)], tmp, world=2))
    return {"ranks": ranks, "dir": tmp / "dcp", "model": model, "module": module}


def test_each_rank_writes_only_its_partition(zero1_world):
    ranks = zero1_world["ranks"]
    owner = {name: r for r, out in enumerate(ranks) for name in out["partition"]}
    assert sorted(owner) == sorted(n for n, _ in zero1_world["module"].named_parameters())
    assert all(out["partition"] for out in ranks)  # ZeRO-1 gave each rank some parameters
    files = ranks[0]["files"]
    assert files == ranks[1]["files"]
    state_keys = [k for k in files if k.startswith("optim.state.")]
    assert {k[len("optim.state."):].rsplit(".", 1)[0] for k in state_keys} == set(owner)
    for key in state_keys:
        name = key[len("optim.state."):].rsplit(".", 1)[0]
        assert files[key].startswith(f"__{owner[name]}_"), (key, files[key])


def test_restore_at_world_two_and_the_resumed_step(zero1_world):
    for out in zero1_world["ranks"]:
        restored = out["restored"]
        assert restored["step"] == 3 and restored["lr"] == 1e-2
        _assert_bitwise(restored["params"], out["at_save"]["params"])
        _assert_bitwise(out["resumed"], out["uninterrupted"])
    rank0 = zero1_world["ranks"][0]
    _assert_bitwise(rank0["restored"]["optimizer"], rank0["at_save"]["optimizer"])


def test_restore_at_world_one_equals_the_consolidated_state(zero1_world):
    module = zero1_world["model"].build_neural_module(device="cpu", seed=1)
    optimizer = torch.optim.Adam(module.parameters(), lr=0.5)
    ckpt = DistributedCheckpointer(zero1_world["dir"])
    assert ckpt.restore(module=module, optimizer=optimizer) == 3
    rank0 = zero1_world["ranks"][0]
    _assert_bitwise({k: v.detach() for k, v in module.named_parameters()}, rank0["at_save"]["params"])
    names = [n for n, _ in module.named_parameters()]
    state = {names[i]: st for i, st in optimizer.state_dict()["state"].items()}
    _assert_bitwise(state, rank0["at_save"]["optimizer"])
    assert optimizer.param_groups[0]["lr"] == 1e-2
    assert type(ckpt.restore_model()).__name__ == type(zero1_world["model"]).__name__
    ckpt.close()
