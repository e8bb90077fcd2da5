"""The pipeline's pure-Python pieces in the port against the JAX
package's (no process group, no training):

* ``runtime/utils.py``: ``partition_uniform`` and ``partition_balanced``
  equal their originals over a grid of item counts, weights and part
  counts; ``call_to_str`` too;
* ``runtime/pipe/schedule.py``: every schedule's instruction stream
  (``InferenceSchedule``, ``TrainSchedule``, ``UniformTrainSchedule``,
  ``DataParallelSchedule``) equal instruction by instruction, and the
  cycle tables (``uniform_train_schedule_tables``,
  ``interleaved_train_schedule_tables``,
  ``packed_inference_schedule_tables``) equal array by array, over (M, S,
  v) with M not a multiple of S included;
* ``parallel/topology.py``: the rank <-> coordinate maps and the grid's
  coordinates for every rank;
* ``runtime/pipe/module.py``: ``parts``, ``stage_depths``,
  ``layers_per_stage`` and the hoisted head and tail equal the JAX
  module's for ``tests/unit/test_pipe_module.py``'s cases (uniform,
  parameters, type:regex, ragged) and GPT-2 pipelines (ragged, v = 2);
  each stage holds only its layers; every stage's part of the JAX
  module's tree, gathered back (``pipe_tree``), is the JAX tree, padded
  slots included.
"""
import numpy as np
import pytest
import torch
from torch import nn

import jax

from deepspeed_tpu.models import gpt2 as jgpt2
from deepspeed_tpu.models import gpt2_pipe as jgpt2_pipe
from deepspeed_tpu.parallel import topology as jtopo
from deepspeed_tpu.runtime import utils as jutils
from deepspeed_tpu.runtime.pipe import module as jmodule
from deepspeed_tpu.runtime.pipe import schedule as jsch
from deepspeed_tpu_torch.models import gpt2 as tgpt2
from deepspeed_tpu_torch.models import gpt2_pipe as tgpt2_pipe
from deepspeed_tpu_torch.parallel import topology as ttopo
from deepspeed_tpu_torch.runtime import utils as tutils
from deepspeed_tpu_torch.runtime.pipe import module as tmodule
from deepspeed_tpu_torch.runtime.pipe import schedule as tsch

pytestmark = pytest.mark.torch_port


@pytest.mark.parametrize("items", [0, 1, 3, 7, 8, 24, 49])
@pytest.mark.parametrize("parts", [1, 2, 3, 4, 8])
def test_partition_copies(items, parts):
    assert tutils.partition_uniform(items, parts) == \
        jutils.partition_uniform(items, parts)
    rng = np.random.RandomState(items * 10 + parts)
    for weights in (list(rng.randint(1, 100, size=items)),
                    [1.0] * items, list(rng.rand(items) * 1e6)):
        assert tutils.partition_balanced(weights, parts) == \
            jutils.partition_balanced(weights, parts), weights
    assert tutils.call_to_str("f", items, k=parts) == \
        jutils.call_to_str("f", items, k=parts)


def _stream(sched):
    return [[(type(c).__name__, c.kwargs) for c in cmds]
            for cmds in sched.steps()]


GRID = [(1, 2), (3, 2), (4, 2), (5, 2), (8, 4), (6, 4), (3, 3), (7, 3)]


@pytest.mark.parametrize("M,S", GRID)
@pytest.mark.parametrize("name", ["InferenceSchedule", "TrainSchedule",
                                  "UniformTrainSchedule",
                                  "DataParallelSchedule"])
def test_schedule_streams_equal(M, S, name):
    for stage in range(S):
        got = getattr(tsch, name)(micro_batches=M, stages=S, stage_id=stage)
        want = getattr(jsch, name)(micro_batches=M, stages=S, stage_id=stage)
        assert _stream(got) == _stream(want), (name, M, S, stage)
        assert got.num_pipe_buffers() == want.num_pipe_buffers()
        assert repr(next(iter(got.steps()), None)) == \
            repr(next(iter(want.steps()), None))


@pytest.mark.parametrize("M,S", GRID)
@pytest.mark.parametrize("v", [1, 2, 3])
def test_schedule_tables_equal(M, S, v):
    for fn in ("interleaved_train_schedule_tables",
               "packed_inference_schedule_tables"):
        got = getattr(tsch, fn)(M, S, v)
        want = getattr(jsch, fn)(M, S, v)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for a, b in zip(tsch.uniform_train_schedule_tables(M, S),
                    jsch.uniform_train_schedule_tables(M, S)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dims", [(2, 2, 1), (2, 2, 2), (4, 1, 2),
                                  (3, 2, 1)])
def test_topology_equal(dims):
    pp, dp, mp = dims
    for name, args in (("PipeModelDataParallelTopology",
                        dict(num_pp=pp, num_mp=mp, num_dp=dp)),
                       ("PipeDataParallelTopology",
                        dict(num_pp=pp, num_dp=dp))):
        t, j = getattr(ttopo, name)(**args), getattr(jtopo, name)(**args)
        assert {tuple(k): v for k, v in t.mapping.items()} == \
            {tuple(k): v for k, v in j.mapping.items()}
        assert t.get_axis_comm_lists("pipe") == j.get_axis_comm_lists("pipe")
        for rank in range(t.world_size()):
            grid = ttopo.MeshGrid(topology=t, process_rank=rank)
            # rank = p * (D * T) + d * T + t, the ProcessMesh's order
            p, rest = divmod(rank, dp * (mp if "Model" in name else 1))
            assert grid.get_stage_id() == p
            assert grid.get_data_parallel_rank() == \
                getattr(t.get_coord(rank), "data")
            assert grid.stage_to_global(p, data=grid.
                                        get_data_parallel_rank(),
                                        model=grid.get_model_parallel_rank()
                                        ) == rank
            assert grid.mesh is None


# tests/unit/test_pipe_module.py's layer list, in both packages


class DenseBlock(tmodule.Layer):
    """The port's ``Layer`` adapter, as the JAX test builds its block."""

    def __init__(self, dim):
        super().__init__(lambda: {"w": torch.randn(dim, dim) * 0.02},
                         lambda p, x: torch.tanh(x @ p["w"]),
                         name="DenseBlock")


class Emb(nn.Module):
    def __init__(self, vocab, dim):
        super().__init__()
        self.wte = nn.Parameter(torch.randn(vocab, dim) * 0.02)

    def forward(self, x):
        return self.wte[x]


class JDenseBlock(jmodule.Layer):
    def __init__(self, dim):
        super().__init__(
            lambda rng: {"w": jax.random.normal(rng, (dim, dim)) * 0.02},
            lambda p, x: jax.numpy.tanh(x @ p["w"]), name="DenseBlock")


JDenseBlock.__name__ = "DenseBlock"


class JEmb(jmodule.Layer):
    def __init__(self, vocab, dim):
        super().__init__(
            lambda rng: {"wte": jax.random.normal(rng, (vocab, dim)) * 0.02},
            lambda p, x: p["wte"][x], name="Emb")


def _specs(pkg, n_blocks=4, vocab=32, dim=16):
    dense, emb = (DenseBlock, Emb) if pkg is tmodule else (JDenseBlock, JEmb)
    return ([pkg.LayerSpec(emb, vocab, dim)] +
            [pkg.LayerSpec(dense, dim) for _ in range(n_blocks)])


def _same_partition(t, j):
    assert t.parts == j.parts
    np.testing.assert_array_equal(t.stage_depths, j.stage_depths)
    assert t.layers_per_stage == j.layers_per_stage
    assert (t.body_start, t.body_end) == (j.body_start, j.body_end)
    assert len(t.pre_layers) == len(j.pre_layers)
    assert len(t.post_layers) == len(j.post_layers)


@pytest.mark.parametrize("method,n_blocks,v", [
    ("uniform", 4, 1), ("parameters", 4, 1), ("type:DenseBlock", 4, 1),
    ("parameters", 3, 1), ("uniform", 7, 2), ("parameters", 5, 2)])
def test_partition_equal_to_jax(method, n_blocks, v):
    j = jmodule.PipelineModule(_specs(jmodule, n_blocks), num_stages=2,
                               partition_method=method,
                               num_virtual_stages=v)
    for stage in range(2):
        t = tmodule.PipelineModule(_specs(tmodule, n_blocks), num_stages=2,
                                   partition_method=method,
                                   num_virtual_stages=v, stage_id=stage)
        _same_partition(t, j)
        # the stage holds its layers only: the embedding on stage 0
        assert (len(t.pre) == 1) == (stage == 0)
        assert [len(chunk) for chunk in t.body] == [
            t.parts[c * 2 + stage + 1] - t.parts[c * 2 + stage]
            for c in range(v)]


def test_type_regex_no_match_raises():
    with pytest.raises(AssertionError):
        tmodule.PipelineModule(_specs(tmodule), num_stages=2,
                               partition_method="type:NoSuchLayer",
                               stage_id=0)


def test_layer_spec_defers_build():
    built = []

    class Counted(Emb):
        def __init__(self, dim):
            built.append(dim)
            super().__init__(4, dim)

    spec = tmodule.LayerSpec(Counted, 8)
    assert not built and "Counted" in repr(spec)
    assert isinstance(spec.build(), Counted) and built == [8]
    with pytest.raises(RuntimeError):
        tmodule.LayerSpec("not-a-class", 8)


@pytest.mark.parametrize("layers,v", [(3, 1), (5, 2), (4, 1)])
def test_gpt2_pipeline_tree_round_trip(layers, v):
    cfg = dict(vocab_size=64, max_seq_len=16, n_layers=layers, n_heads=2,
               d_model=32)
    jnet = jgpt2_pipe.make_gpt2_pipeline(
        config=jgpt2.GPT2Config(**cfg), num_stages=2,
        num_virtual_stages=v)
    tree = jax.tree_util.tree_map(np.asarray, jnet.params)
    states = []
    for stage in range(2):
        t = tgpt2_pipe.make_gpt2_pipeline(
            config=tgpt2.GPT2Config(**cfg), num_stages=2, stage_id=stage,
            num_virtual_stages=v, seed=None)
        _same_partition(t, jnet)
        t.load_pipe_tree(tree)
        assert ("embed" in t.tied) and (len(t.post) == (stage == 1))
        states.append({n: p.detach() for n, p in t.named_parameters()})
    back = t.pipe_tree(states)
    flat_back = dict(_leaves(back))
    flat_want = dict(_leaves(tree))
    assert sorted(flat_back) == sorted(flat_want)
    for key, want in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_back[key]), want,
                                      err_msg=key)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + str(key) + ".")
    elif isinstance(tree, (list, tuple)):
        for i, child in enumerate(tree):
            yield from _leaves(child, prefix + str(i) + ".")
    elif tree is not None:
        yield prefix[:-1], tree


def test_gpt2_pipeline_seed_is_dense_init():
    """``make_gpt2_pipeline(seed=s)``: each stage's weights are the dense
    model's of the same seed."""
    cfg = tgpt2.GPT2Config(vocab_size=64, max_seq_len=16, n_layers=3,
                           n_heads=2, d_model=32)
    dense = dict(tgpt2.make_gpt2_model(config=cfg, seed=3).named_parameters())
    for stage in range(2):
        t = tgpt2_pipe.make_gpt2_pipeline(config=cfg, num_stages=2,
                                          stage_id=stage, seed=3)
        for name, p in t.named_parameters():
            head, rest = name.split(".", 1)
            if head == "tied":
                key = rest.split(".", 1)[1]
            elif head == "post":
                key = "ln_f." + rest.split(".", 1)[1]
            else:
                c, j, inner = rest.split(".", 2)
                key = "blocks.{}.{}".format(t.body_ids(int(c))[int(j)],
                                            inner)
            assert torch.equal(p, dense[key]), name
