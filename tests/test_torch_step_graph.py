"""The env step stays capturable in a CUDA graph (envs/go1_env: on the card
`LeggedRobotEnv.step` replays one graph per control step), checked on the
CPU: the step makes no tensor from host data (a copy from pageable memory,
which a graph cannot capture) and reads no device value on the host; the
graph's grouped copies keep every leaf;
off the card the step runs eagerly and is counted so.  The replay itself
against the eager step is `tests/test_torch_gpu.py`'s
`test_graphed_step_is_the_eager_step_bit_for_bit_on_the_card`."""
import traceback

import pytest
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from walk_these_ways_tpu_torch.envs import go1_env
from walk_these_ways_tpu_torch.envs.go1_env import (LeggedRobotEnv,
                                                    make_generator)
from walk_these_ways_tpu_torch.go1_config import (mob_train_cfg,
                                                  rough_train_cfg)

N = 16

# what a CUDA graph cannot capture: a tensor made from host data, and a
# device value read on the host (`.item()`)
UNCAPTURABLE = (torch.ops.aten.lift_fresh.default,
                torch.ops.aten._local_scalar_dense.default)


class Uncapturable(TorchDispatchMode):
    """Counts the ops run under it and records each uncapturable one with
    the port's lines it came from."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        if func in UNCAPTURABLE:
            self.found.append((str(func), [
                f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno}"
                for f in traceback.extract_stack()
                if "walk_these_ways_tpu_torch" in f.filename][-3:]))
        return func(*args, **(kwargs or {}))


def _env(terrain="flat"):
    torch.set_num_threads(1)
    cfg = {"flat": mob_train_cfg, "rough": rough_train_cfg}[terrain](N)
    env = LeggedRobotEnv(cfg, device="cpu")
    gen = make_generator(0, "cpu")
    state, obs = env.reset(gen)
    return env, state, torch.randn((N, 12), generator=gen)


@pytest.mark.parametrize("terrain", ["flat", "rough"])
def test_env_step_makes_no_host_tensor_and_reads_no_device_value(terrain):
    """mob_train_cfg and rough_train_cfg (heightfield, teleport): one step
    under a dispatch mode issues no aten.lift_fresh and no
    aten._local_scalar_dense."""
    env, state, actions = _env(terrain)
    mode = Uncapturable()
    with mode:
        env.step(state, actions)
    assert mode.ops > 1000
    assert mode.found == []


def test_graph_copies_keep_every_leaf():
    """`_copy` fills fresh tensors from a step's outputs (the dense ones of
    each dtype through the multi-tensor copy, a strided view one by one)
    bit for bit."""
    env, state, actions = _env()
    leaves, _ = pytree.tree_flatten(env.step(state, actions))
    srcs = [x for x in leaves if isinstance(x, torch.Tensor)]
    srcs.append(state.lag_buffer[:, 1:])         # strided, not dense
    assert {x.dtype for x in srcs} >= {torch.float32, torch.int32,
                                       torch.bool}
    dsts = [torch.empty_like(x) for x in srcs]
    go1_env._copy(dsts, srcs, [go1_env._dense(x) for x in dsts])
    assert all(torch.equal(d, s) for d, s in zip(dsts, srcs))


def test_env_steps_eagerly_off_the_card():
    """On the CPU the env takes no graph: the reset's step and each later
    one run eagerly and count as eager steps."""
    counts = (go1_env.graph_captures, go1_env.graph_replays)
    eager = go1_env.eager_steps
    env, state, actions = _env()
    assert not env.graphed
    for _ in range(2):
        state, *_ = env.step(state, actions)
    assert env._graph is None
    assert go1_env.eager_steps == eager + 3
    assert (go1_env.graph_captures, go1_env.graph_replays) == counts
