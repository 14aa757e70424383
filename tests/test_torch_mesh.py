"""Port parity: the rank substrate (``fleetx_tpu_torch/parallel/mesh.py``,
``parallel/rules.py``, ``utils/config.py``'s degree math) against the JAX
package's mesh, partition rules and ``process_dist_config``, on the CPU
without a process group (``build_mesh(..., world_size=n)`` lays the ranks
out as JAX's ``build_mesh(..., devices=jax.devices()[:n])`` lays devices).

Everything here is exact: coordinates, degrees, specs and error messages
compare equal.
"""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "fleetx_tpu", "configs")
GPT = os.path.join(CONFIGS, "nlp", "gpt")

MESHES = [{"fsdp_degree": 2, "mp_degree": 2}, {"dp_degree": 2, "mp_degree": 2},
          {"dp_degree": 4}, {"pp_degree": 2, "dp_degree": 2}]


@pytest.mark.parametrize("dist", MESHES, ids=lambda d: "-".join(
    f"{k[:-7]}{v}" for k, v in d.items()))
def test_rank_coordinates_follow_jax_device_order(dist, devices8):
    import jax

    from fleetx_tpu.parallel.mesh import build_mesh as j_build_mesh
    from fleetx_tpu_torch.parallel.mesh import MeshEnv, build_mesh

    devices = jax.devices()[:4]
    jmesh = j_build_mesh(dist, devices=devices)
    mesh = build_mesh(dist, world_size=4)
    assert mesh.shape == dict(jmesh.shape) and mesh.size == jmesh.size
    for rank, device in enumerate(devices):
        where = np.argwhere(jmesh.devices == device)[0]
        want = {a: int(i) for a, i in zip(jmesh.axis_names, where)}
        assert mesh.coords(rank) == want, (rank, dist)
    env = MeshEnv(mesh)
    assert (env.dp_world_size, env.mp_world_size, env.pp_world_size,
            env.sp_world_size) == (
        mesh.shape["data"] * mesh.shape["fsdp"], mesh.shape["tensor"],
        mesh.shape["pipe"], mesh.shape["seq"])


def test_coordinates_and_trivial_collectives():
    import torch

    from fleetx_tpu_torch.parallel import mesh as M

    mesh = M.build_mesh({"fsdp_degree": 2, "mp_degree": 2}, world_size=4,
                        rank=3)
    assert mesh.coords() == {"pipe": 0, "data": 0, "fsdp": 1, "seq": 0,
                             "tensor": 1}
    assert mesh.coords(1) == {"pipe": 0, "data": 0, "fsdp": 0, "seq": 0,
                              "tensor": 1}
    # a layout without a process group has no collectives on its real axes
    with pytest.raises(RuntimeError, match="no process group"):
        M.psum(torch.ones(2), "tensor", mesh)
    # every collective is the identity at axis size 1 (and without a mesh)
    x = torch.arange(4.0)
    one = M.build_mesh({}, world_size=1)
    for fn in (M.psum, M.pmax):
        assert fn(x, "data", one) is x and fn(x, "tensor", None) is x
    assert M.all_gather(x, "fsdp", one) is x
    assert M.axis_index("tensor", None) == 0
    assert M.broadcast_object({"a": 1}, one) == {"a": 1}
    assert M.gather_objects(7, one) == [7]


DEGREE_CASES = [
    ({}, 1), ({}, 8), ({"dp_degree": 8}, 8), ({"mp_degree": 2}, 8),
    ({"fsdp_degree": 2, "mp_degree": 2}, 4),
    ({"sharding": {"sharding_degree": 4}}, 8),
    ({"pp_degree": 2, "seq_degree": 2, "dp_degree": -1}, 8),
    ({"dp_degree": 2, "mp_degree": 2, "fsdp_degree": 2}, 8),
    # the asserting cases
    ({"dp_degree": 8}, 1), ({"mp_degree": 3}, 8),
    ({"dp_degree": 2, "mp_degree": 2}, 8), ({"mp_degree": 2}, 1),
]


@pytest.mark.parametrize("dist,n", DEGREE_CASES,
                         ids=[f"{i}" for i in range(len(DEGREE_CASES))])
def test_process_dist_config_matches_jax(dist, n):
    import copy

    from fleetx_tpu.utils import config as J
    from fleetx_tpu_torch.utils import config as T

    def run(mod):
        cfg = mod.create_attr_dict({"Distributed": copy.deepcopy(dist)})
        try:
            mod.process_dist_config(cfg, num_devices=n)
        except (AssertionError, ValueError) as e:
            return ("raises", str(e))
        return ("ok", dict(cfg["Distributed"]))

    want, got = run(J), run(T)
    assert got == want


def test_build_mesh_raises_jaxs_world_mismatch():
    import jax

    from fleetx_tpu.parallel.mesh import build_mesh as j_build_mesh
    from fleetx_tpu_torch.parallel.mesh import build_mesh

    for dist in ({"mp_degree": 2}, {"dp_degree": 2}, {"dp_degree": 3}):
        with pytest.raises(AssertionError) as want:
            j_build_mesh(dist, devices=jax.devices()[:1])
        with pytest.raises(ValueError) as got:
            build_mesh(dist)              # a world of one rank
        assert str(got.value) == str(want.value)


def _jax_gpt_leaves():
    """(name, shape) of every leaf of the tiny JAX GPT's param tree."""
    import jax
    import jax.numpy as jnp
    from flax.core import meta

    from fleetx_tpu.models.gpt.model import (GPTForPretraining,
                                             config_from_dict)
    from fleetx_tpu.parallel.rules import tree_leaf_names

    cfg = config_from_dict(dict(vocab_size=97, hidden_size=64, num_layers=2,
                                num_attention_heads=4,
                                max_position_embeddings=64, dtype="float32"))
    params = jax.eval_shape(lambda: meta.unbox(GPTForPretraining(cfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 8), jnp.int32),
        None, deterministic=True)["params"]))
    return [(name, tuple(leaf.shape))
            for name, leaf in tree_leaf_names(params)]


@pytest.mark.parametrize("stage,sp", [(0, False), (3, False), (1, True)])
def test_spec_for_and_kv_pool_spec_match_jax(stage, sp):
    from fleetx_tpu.parallel import rules as J
    from fleetx_tpu_torch.parallel import rules as T

    leaves = _jax_gpt_leaves()
    assert len(leaves) == 16
    jl = J.SpecLayout(stage=stage, sequence_parallel=sp)
    tl = T.SpecLayout(stage=stage, sequence_parallel=sp)
    assert tl.axis_rules() == jl.axis_rules()
    assert T.MESH_AXES == J.MESH_AXES
    for name, shape in leaves:
        assert T.spec_for("gpt", name, shape, tl) == \
            tuple(J.spec_for("gpt", name, shape, jl)), name
    assert T.kv_pool_spec(tl) == tuple(J.kv_pool_spec(jl))
    assert T.kv_pool_spec() == (None, "fsdp", None, "tensor")
    dist = {"sharding": {"sharding_stage": stage}, "sequence_parallel": sp}
    assert T.SpecLayout.from_dist_config(dist) == tl
    with pytest.raises(KeyError, match="no partition rule"):
        T.spec_for("gpt", "gpt/mystery", (3, 4))
    assert T.spec_for("gpt", "gpt/mystery", (1, 1)) == ()


def test_shard_leaf_blocks_assemble_the_leaf():
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.parallel.rules import block_range, shard_leaf

    leaf = np.arange(97 * 6).reshape(97, 6)      # an uneven vocab split
    spec = ("tensor", "fsdp")
    parts = {}
    for rank in range(4):
        mesh = build_mesh({"fsdp_degree": 2, "mp_degree": 2}, world_size=4,
                          rank=rank)
        parts[rank] = shard_leaf(leaf, spec, mesh)
        whole = shard_leaf(leaf, spec, mesh, keep=("fsdp",))
        lo, hi = block_range(97, 2, mesh.axis_index("tensor"))
        assert np.array_equal(whole, leaf[lo:hi])
    assert parts[0].shape == (49, 3) and parts[3].shape == (48, 3)
    top = np.concatenate([parts[0], parts[2]], axis=1)
    bottom = np.concatenate([parts[1], parts[3]], axis=1)
    assert np.array_equal(np.concatenate([top, bottom]), leaf)


def test_load_params_slices_equal_the_engines_and_are_refused_by_it(
        tmp_path):
    """``load_params(mesh=...)`` and ``shard_params`` cut a rank's slices
    in one place (``shard_tree``); ``ServingEngine(mesh=...)`` takes only
    the full params, so it refuses those slices and a tree of another
    depth before cutting anything."""
    import torch

    from fleetx_tpu_torch.core import checkpoint as C
    from fleetx_tpu_torch.models.gpt.model import (config_from_dict,
                                                   init_params)
    from fleetx_tpu_torch.parallel.mesh import build_mesh
    from fleetx_tpu_torch.serving.decode import shard_params
    from fleetx_tpu_torch.serving.engine import ServingConfig, ServingEngine

    model = dict(vocab_size=97, hidden_size=64, num_layers=2,
                 num_attention_heads=4, max_position_embeddings=64,
                 dtype="float32", param_dtype="float32")
    cfg = config_from_dict(model)
    full = init_params(cfg, seed=0, device="cpu")
    C.save_checkpoint(str(tmp_path), 1,
                      dict(step=1, **C.flatten(full, "params/")))
    serving = ServingConfig(max_batch=2, page_size=4, num_pages=32,
                            max_seq_len=32)
    for rank in range(4):
        mesh = build_mesh({"fsdp_degree": 2, "mp_degree": 2}, world_size=4,
                          rank=rank)
        loaded = C.flatten(C.load_params(str(tmp_path), mesh=mesh))
        cut = C.flatten(shard_params(full, cfg, mesh))
        assert loaded.keys() == cut.keys()
        for name, t in cut.items():
            assert torch.equal(loaded[name], t), name
        qkv = loaded["gpt/layers/attn/qkv_kernel"]
        assert tuple(qkv.shape) == (2, 64, 3, 2, 16)     # heads over mp
        deeper = config_from_dict(dict(model, num_layers=1))
        for params, model_cfg in ((C.unflatten(loaded), cfg),
                                  (full, deeper)):
            with pytest.raises(ValueError, match="!= expected"):
                ServingEngine(model_cfg, params, serving, device="cpu",
                              mesh=mesh)


TRAINING_REFUSED = [
    os.path.join(CONFIGS, "multimodal", "imagen",
                 "imagen_397M_text2im_64x64_bs2048_dp64.yaml"),
    os.path.join(CONFIGS, "nlp", "ernie", "pretrain_ernie_345M_dp8.yaml"),
    os.path.join(GPT, "pretrain_gpt_1.3B_dp8.yaml"),
    os.path.join(GPT, "pretrain_gpt_1.3B_seq8k_ring.yaml"),
    os.path.join(GPT, "pretrain_gpt_175B_mp8_pp16.yaml"),
    os.path.join(GPT, "pretrain_gpt_345M_mp8_qat.yaml"),
    os.path.join(GPT, "pretrain_gpt_6.7B_sharding16.yaml"),
    os.path.join(GPT, "auto", "pretrain_gpt_6.7B_sharding16.yaml"),
    os.path.join(GPT, "pretrain_gpt_moe_8expert_mp4.yaml"),
]
#: the recipes of TRAINING_REFUSED the sharded training step opens, with
#: the world of ranks their degrees fill
TRAINING_OPENED = {"imagen_397M_text2im_64x64_bs2048_dp64": 64,
                   "pretrain_ernie_345M_dp8": 8, "pretrain_gpt_1.3B_dp8": 8,
                   "pretrain_gpt_345M_mp8_qat": 8,
                   "pretrain_gpt_6.7B_sharding16": 16}


@pytest.mark.parametrize("path", TRAINING_REFUSED,
                         ids=lambda p: os.path.basename(p)[:-5])
def test_training_loaders_still_refuse_a_world(path):
    """The recipes the sharded step covers load at their degrees against
    the matching world, as JAX's loader resolves them; a pipeline, the
    ring over seq ranks and MoE over tensor still raise naming item 12;
    in a world of one rank an opened recipe is JAX's world mismatch."""
    from fleetx_tpu.utils.config import get_config as j_get_config
    from fleetx_tpu_torch.tools.train import load_config

    name = os.path.basename(path)[:-5]
    world = TRAINING_OPENED.get(name)
    if world is None:
        with pytest.raises(NotImplementedError, match="item 12"):
            load_config(path, device="cpu", world_size=512)
        return
    got = load_config(path, device="cpu", world_size=world)
    want = j_get_config(path, num_devices=world)
    for key in ("dp_degree", "mp_degree", "pp_degree", "fsdp_degree",
                "seq_degree"):
        assert got["Distributed"][key] == want["Distributed"][key], key
    assert dict(got["Distributed"]["sharding"]) == {
        k: v for k, v in dict(want["Distributed"]["sharding"]).items()
        if k in got["Distributed"]["sharding"]}
    for key in ("global_batch_size", "local_batch_size",
                "micro_batch_size"):
        assert got["Global"][key] == want["Global"][key], key
    with pytest.raises(ValueError, match="device count"):
        load_config(path, device="cpu", world_size=1)


@pytest.mark.parametrize("name", ["generation_gpt_345M_dp8",
                                  "inference_gpt_345M_dp8"])
def test_dp8_serving_recipes_load_against_a_world_of_eight(name):
    from fleetx_tpu.utils.config import get_config as j_get_config
    from fleetx_tpu_torch.tasks.gpt.generation import load_config
    from fleetx_tpu_torch.utils.config import get_config

    path = os.path.join(GPT, f"{name}.yaml")
    want = j_get_config(path, num_devices=8)
    for cfg in (get_config(path, num_devices=8),
                load_config(path, num_devices=8)):
        assert dict(cfg["Distributed"]) == {
            k: v for k, v in dict(want["Distributed"]).items()
            if k in cfg["Distributed"]}
        assert cfg["Distributed"]["dp_degree"] == 8
        assert cfg["Global"]["global_batch_size"] == \
            want["Global"]["global_batch_size"]
    with pytest.raises(ValueError, match=r"dp\(8\).*device count \(1\)"):
        get_config(path, num_devices=1)
