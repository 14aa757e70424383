"""Port parity: the LoRA adapter algebra (``fleetx_tpu_torch/finetune/
lora.py`` against ``fleetx_tpu/finetune/lora.py``) and the masked
optimizer against the JAX ``lora_optimizer`` chain.

The JAX params come from ``model.init(PRNGKey(0))`` at the tiny serving
config (hidden 64, 2 layers, 4 heads, f32) with the JAX adapters injected
and B filled with seeded noise, and pass through
``convert.params_from_jax`` (which carries the adapter leaves), so both
sides fold the same numbers.

Tolerances: names, shapes, masks and the trainable fraction exact; the
merged kernels within 1e-6 relative to each kernel's largest magnitude
(f32: a rank-4 product summed by another library); the optimizer's
params within rtol 1e-6 and atol 1e-4 x the learning rate after each of
3 steps, the bound ``tests/test_torch_train.py`` holds the port's AdamW
to against optax (the bias corrections are formed in double here and in
f32 by optax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import meta

from fleetx_tpu.finetune import lora as JL
from fleetx_tpu.models.gpt.model import GPTForPretraining
from fleetx_tpu.models.gpt.model import config_from_dict as j_config
from fleetx_tpu.optims import optimizer as JOPT
from fleetx_tpu.parallel import rules as R
from fleetx_tpu_torch.convert import check_tree, params_from_jax
from fleetx_tpu_torch.core.checkpoint import flatten
from fleetx_tpu_torch.finetune import checkpoint as TC
from fleetx_tpu_torch.finetune import lora as TL
from fleetx_tpu_torch.models.gpt.model import config_from_dict as t_config
from fleetx_tpu_torch.models.gpt.model import init_params
from fleetx_tpu_torch.optims import optimizer as TOPT

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """This file's tensors are tiny: torch runs them on one intra-op
    thread (its default pool, on cores the other test workers share,
    costs far more than the work). The count is restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

MODEL = dict(vocab_size=97, hidden_size=64, num_layers=2,
             num_attention_heads=4, max_position_embeddings=64,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
             use_flash_attention=False, dtype="float32",
             param_dtype="float32")
RANK, ALPHA = 4, 8.0


@pytest.fixture(scope="module")
def trees():
    """(JAX adapted tree as numpy, the port's conversion of it)."""
    model = GPTForPretraining(j_config(MODEL))

    @jax.jit
    def adapted_init(key):
        params = meta.unbox(model.init(
            {"params": key}, jnp.zeros((1, 8), jnp.int32), None,
            deterministic=True)["params"])
        return JL.inject_adapters(params, rank=RANK,
                                  rng=jax.random.fold_in(key, 1))

    adapted = jax.device_get(adapted_init(jax.random.PRNGKey(0)))
    rng = np.random.RandomState(0)
    for group in adapted["gpt"]["layers"].values():
        for key in list(group):
            if key.endswith("_lora_b"):
                group[key] = (0.05 * rng.randn(*group[key].shape)).astype(
                    np.float32)
    return adapted, params_from_jax(adapted, t_config(MODEL))


def _names(tree) -> dict:
    return {n: tuple(np.shape(l)) for n, l in R.tree_leaf_names(tree)}


def test_inject_names_and_shapes_equal_jax(trees):
    want = _names(trees[0])   # the JAX inject_adapters output
    base = init_params(t_config(MODEL), seed=3)
    adapted = TL.inject_adapters(base, rank=RANK, seed=5)
    got = {n: tuple(t.shape) for n, t in flatten(adapted).items()}
    assert got == want
    assert sorted(n for n in got if TL.is_adapter_name(n)) == sorted(
        n for n in want if JL.is_adapter_name(n))
    # B starts at zeros and A is N(0, 0.02); every base leaf is the same
    # tensor, so the merged tree IS the base
    for name, leaf in flatten(adapted).items():
        if name.endswith("_lora_b"):
            assert torch.count_nonzero(leaf) == 0
        elif name.endswith("_lora_a"):
            assert 0.01 < float(leaf.std()) < 0.03
    merged = TL.merge_adapters(adapted, ALPHA)
    for (name, a), b in zip(flatten(merged).items(), flatten(base).values()):
        assert torch.equal(a, b), name
    # the same seed draws the same A; another seed another one
    again = TL.inject_adapters(base, rank=RANK, seed=5)
    other = TL.inject_adapters(base, rank=RANK, seed=6)
    a_name = "gpt/layers/attn/qkv_kernel_lora_a"
    assert torch.equal(flatten(again)[a_name], flatten(adapted)[a_name])
    assert not torch.equal(flatten(other)[a_name], flatten(adapted)[a_name])


def test_convert_carries_adapter_leaves_and_checks_them(trees):
    adapted, tparams = trees
    got = {n: tuple(t.shape) for n, t in flatten(tparams).items()}
    assert got == _names(adapted)
    for name, leaf in R.tree_leaf_names(adapted):
        np.testing.assert_array_equal(flatten(tparams)[name].numpy(),
                                      np.asarray(leaf))
    check_tree(adapted, t_config(MODEL))
    bad = jax.tree.map(lambda x: x, adapted)
    bad["gpt"]["layers"]["mlp"]["wi_kernel_lora_b"] = np.zeros((2, 3, 256))
    with pytest.raises(ValueError, match="wi_kernel_lora_b"):
        params_from_jax(bad, t_config(MODEL))
    bad = jax.tree.map(lambda x: x, adapted)
    del bad["gpt"]["layers"]["mlp"]["wi_kernel_lora_b"]
    with pytest.raises(ValueError, match="missing leaves"):
        params_from_jax(bad, t_config(MODEL))


def test_merge_matches_jax(trees):
    adapted, tparams = trees
    want = dict(R.tree_leaf_names(JL.merge_adapters(adapted, alpha=ALPHA)))
    got = flatten(TL.merge_adapters(tparams, ALPHA))
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        w = np.asarray(want[name])
        err = np.abs(leaf.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= 1e-6, (name, err)
    # adapter_delta alone, on the stacked qkv pair
    attn = tparams["gpt"]["layers"]["attn"]
    jattn = adapted["gpt"]["layers"]["attn"]
    delta = TL.adapter_delta(attn["qkv_kernel_lora_a"],
                             attn["qkv_kernel_lora_b"],
                             tuple(attn["qkv_kernel"].shape))
    np.testing.assert_allclose(
        delta.numpy(), np.asarray(JL.adapter_delta(
            jnp.asarray(jattn["qkv_kernel_lora_a"]),
            jnp.asarray(jattn["qkv_kernel_lora_b"]),
            jattn["qkv_kernel"].shape)), rtol=0, atol=1e-7)


def test_merge_is_differentiable_to_the_adapters(trees):
    _, tparams = trees
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in flatten(tparams).items()}
    from fleetx_tpu_torch.core.checkpoint import unflatten

    merged = TL.merge_adapters(unflatten(leaves), ALPHA)
    loss = sum((v * v).sum() for v in flatten(merged).values())
    names = sorted(leaves)
    grads = dict(zip(names, torch.autograd.grad(
        loss, [leaves[n] for n in names])))
    for name in names:
        if TL.is_adapter_name(name):
            assert float(grads[name].abs().max()) > 0, name


def test_split_combine_round_trip(trees):
    adapted, tparams = trees
    base, adapters = TL.split_adapters(tparams)
    j_base, j_adapters = JL.split_adapters(adapted)
    assert sorted(adapters) == sorted(j_adapters)
    assert _names(j_base) == {n: tuple(t.shape)
                              for n, t in flatten(base).items()}
    back = TL.combine_adapters(base, adapters)
    assert list(flatten(back)) != [] and sorted(flatten(back)) == sorted(
        flatten(tparams))
    for name, leaf in flatten(back).items():
        assert leaf is flatten(tparams)[name], name
    # combine copies the dicts: the base tree is not grafted in place
    assert not any(TL.is_adapter_name(n) for n in flatten(base))
    with pytest.raises(KeyError, match="missing scope"):
        TL.combine_adapters(base, {"gpt/nowhere/x_lora_a": torch.zeros(1)})


def test_adapter_mask_and_trainable_frac_match_jax(trees):
    adapted, tparams = trees
    want = dict(R.tree_leaf_names(JL.adapter_mask(adapted)))
    got = flatten(TL.adapter_mask(tparams))
    assert got == want
    assert sum(got.values()) == 8
    assert TL.trainable_params_frac(tparams) == JL.trainable_params_frac(
        adapted)


def test_family_fingerprint_is_the_ports_constant():
    """An artifact either package writes loads in the other: the port
    stamps and accepts the JAX ``gpt_lora`` rule table's fingerprint."""
    assert R.family_fingerprint(TC.GPT_LORA_FAMILY) == \
        TC.GPT_LORA_FINGERPRINT


def test_base_leaf_digests_match_jax(trees):
    adapted, tparams = trees
    want = JL.base_leaf_digests(adapted)
    got = TL.base_leaf_digests(tparams)
    assert sorted(got) == sorted(want)
    for name in want:
        assert (got[name]["crc32"], got[name]["nbytes"]) == (
            want[name]["crc32"], want[name]["nbytes"]), name
    bf = TL.base_leaf_digests({"w": torch.ones(3, dtype=torch.bfloat16)})
    import ml_dtypes

    ref = JL.base_leaf_digests({"w": np.ones(3, ml_dtypes.bfloat16)})
    assert bf["w"]["crc32"] == ref["w"]["crc32"]


def test_lora_optimizer_matches_the_jax_masked_chain(trees):
    """3 steps of the masked AdamW with a clip that triggers, the norm
    threaded in as the JAX engine does (``optax.global_norm`` of ALL
    grads, base included): adapter leaves match optax, base leaves are
    untouched, and the moments exist for the adapters alone. Clipping by
    the adapters' norm instead gives other params (the reading matters)."""
    adapted, tparams = trees
    opt_cfg = {"name": "AdamW", "grad_clip": {"clip_norm": 0.5}}
    lr = 1e-2
    j_tx = optax.with_extra_args_support(
        JL.lora_optimizer(JOPT.build_optimizer(opt_cfg, lambda s: lr)))
    j_params = jax.tree.map(jnp.asarray, adapted)
    j_state = j_tx.init(j_params)
    j_update = jax.jit(lambda g, st, p, n: j_tx.update(g, st, p,
                                                       grad_norm=n))
    t_opt = TL.lora_optimizer(TOPT.build_optimizer(opt_cfg, lambda s: lr))
    t_params = {k: v.clone() for k, v in flatten(tparams).items()}
    from fleetx_tpu_torch.core.checkpoint import unflatten

    t_tree = unflatten(t_params)
    t_state = t_opt.init(t_tree)
    assert sorted("mu/" + n for n in flatten(TL.split_adapters(
        tparams)[1])) == sorted(k for k in t_opt.flat_state(
            t_state, t_tree) if k.startswith("mu/"))
    leaves = [v for _, v in TOPT.tree_leaves_with_path(t_tree)]
    names = ["/".join(p) for p, _ in TOPT.tree_leaves_with_path(t_tree)]
    base_before = {n: v.clone() for n, v in zip(names, leaves)
                   if not TL.is_adapter_name(n)}
    rng = np.random.RandomState(1)
    norms = []
    for step in range(3):
        # base grads dominate the norm and change scale between steps
        scale = {n: (30.0 * (step + 1) if not TL.is_adapter_name(n) else
                     0.1) for n in names}
        g_np = {n: (scale[n] * rng.randn(*v.shape)).astype(np.float32)
                for n, v in zip(names, leaves)}
        j_grads = jax.tree.map(jnp.asarray, _nest(g_np))
        j_norm = optax.global_norm(j_grads)
        updates, j_state = j_update(j_grads, j_state, j_params, j_norm)
        j_params = optax.apply_updates(j_params, updates)
        grads = [torch.from_numpy(g_np[n]) for n in names]
        g_norm = t_opt.update(leaves, grads, t_state)
        norms.append((float(g_norm), float(j_norm)))
        assert float(j_norm) > 0.5  # the clip triggers
        want = dict(R.tree_leaf_names(j_params))
        for n, v in zip(names, leaves):
            np.testing.assert_allclose(v.numpy(), np.asarray(want[n]),
                                       rtol=1e-6, atol=1e-4 * lr, err_msg=n)
    for n, before in base_before.items():
        assert torch.equal(flatten(t_tree)[n], before), n
    np.testing.assert_allclose(*zip(*norms), rtol=1e-6)

    # the same steps clipped by the adapters' own norm land elsewhere
    other = TL.lora_optimizer(TOPT.build_optimizer(opt_cfg, lambda s: lr))
    o_tree = unflatten({k: v.clone() for k, v in flatten(tparams).items()})
    o_state = other.init(o_tree)
    o_leaves = [v for _, v in TOPT.tree_leaves_with_path(o_tree)]
    rng = np.random.RandomState(1)
    idx = [i for i, n in enumerate(names) if TL.is_adapter_name(n)]
    for step in range(3):
        scale = {n: (30.0 * (step + 1) if not TL.is_adapter_name(n) else
                     0.1) for n in names}
        grads = [torch.from_numpy((scale[n] * rng.randn(*v.shape)).astype(
            np.float32)) for n, v in zip(names, o_leaves)]
        own = TOPT.global_norm([grads[i] for i in idx])
        other.update(o_leaves, grads, o_state, g_norm=own)
    diff = max(float((o_leaves[i] - leaves[i]).abs().max()) for i in idx)
    assert diff > 1e-5, diff


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, leaf in flat.items():
        node = out
        *parents, last = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out
