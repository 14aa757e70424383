"""Port parity: the Imagen cascade (``fleetx_tpu_torch/models/imagen/``,
``data/dataset/multimodal_dataset.py``, ``tasks/imagen/generate.py``,
``convert.imagen_params_from_jax``).

A tiny stage (dim 16, ``dim_mults`` (1, 2), 16² images, 2 heads, cond
width 16, 4 latents, 4 timesteps; the SR stage conditions on 8² low-res
images) is built once per kind with the JAX package; its weights are
drawn with numpy in JAX's layout (the tree JAX's init makes, checked
abstractly) and converted, and the same numpy inputs go through both. The random draws
of the loss and of the sampler are JAX's, fed to the port's functions
(``split(make_rng("diffusion"), 4)`` for the loss, the ``split`` chain of
``sample``): the functions are the same, ``jax.random``'s bits are not
torch's.

Tolerances (f32 unless said): the U-Net's output atol 1e-5 (two
libraries' convolutions, norms and softmax summing in another order; the
largest output is ~2); the stage loss atol 1e-5 (eps; v with p2 weights
and the low-res augmentation) and every grad leaf within 1e-5 of that
leaf's largest magnitude (the attention key biases, whose grads are 0 in
exact arithmetic and round-off on both sides, within 1e-7 of the largest
grad of all); a 4-timestep ``sample`` with CFG and dynamic
thresholding atol 1e-4 (four steps of divisions by ``sqrt(alpha_bar)``
and a per-sample quantile amplify the U-Net's 1e-6 differences); bf16
drift bound: the output within 2**-4 of its largest magnitude (every
convolution, projection and the compute-dtype softmax round to bf16, 8
bits of mantissa, through some 30 layers, in another order); the
datasets bit for bit; the decay mask leaf by leaf.
"""

import base64
import functools
import io
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax.core import meta

from fleetx_tpu.data.dataset import multimodal_dataset as JD
from fleetx_tpu.models.imagen.modeling import build_stage as j_build_stage
from fleetx_tpu.optims import optimizer as JOPT
from fleetx_tpu_torch.convert import check_imagen_tree, imagen_params_from_jax
from fleetx_tpu_torch.data import build_dataloader, build_dataset
from fleetx_tpu_torch.data.dataset import multimodal_dataset as TD
from fleetx_tpu_torch.models import build_module
from fleetx_tpu_torch.models.imagen import unet as U
from fleetx_tpu_torch.models.imagen.modeling import build_stage
from fleetx_tpu_torch.models.imagen.module import ImagenModule
from fleetx_tpu_torch.optims import optimizer as TOPT
from fleetx_tpu_torch.optims.optimizer import tree_leaves_with_path

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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "multimodal",
                         "imagen", "imagen_397M_text2im_64x64.yaml")
SR_YAML = os.path.join(REPO, "fleetx_tpu", "configs", "multimodal",
                       "imagen", "imagen_super_resolution_256.yaml")
B, SIZE, LOW, TEXT, TLEN = 2, 16, 8, 8, 5
TINY = dict(dim=16, dim_mults=(1, 2), num_res_blocks=2, text_embed_dim=TEXT,
            cond_dim=16, num_attn_heads=2, layer_attns=(False, True),
            layer_cross_attns=(False, True), num_latents=4, timesteps=4,
            dtype="float32", param_dtype="float32")
KINDS = {"base": dict(TINY),
         "sr": dict(TINY, lowres_cond=True, lowres_noise_aug=0.25)}
#: the stage-loss cases: (kind, Model overrides)
LOSSES = {"base_eps": ("base", {}),
          "sr_v_p2": ("sr", dict(pred_type="v", p2_loss_weight_gamma=0.5,
                                 p2_loss_weight_k=1.0))}


def _inputs(kind: str, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    out = {"images": rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(
               np.float32),
           "text_embeds": rng.randn(B, TLEN, TEXT).astype(np.float32),
           "text_mask": np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]],
                                 np.int32)}
    if kind == "sr":
        out["lowres_images"] = rng.uniform(-1, 1, (B, LOW, LOW, 3)).astype(
            np.float32)
    return out


def _torch(d: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _numpy_tree(shapes, seed: int = 0) -> dict:
    """JAX-layout weights drawn with numpy: kernels N(0, 1/fan_in) (the
    init's scale), biases 0.05, norm scales 1 ± 0.1, ``latents`` and
    ``null_text`` N(0, 0.5) (nonzero biases and latents make every path
    of the grads show)."""
    rng = np.random.RandomState(seed)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        if path[-1] == "scale":
            return (1 + 0.1 * rng.randn(*node)).astype(np.float32)
        if path[-1] == "kernel":
            fan_in = int(np.prod(node[:-1])) if len(node) == 4 else (
                node[0] * node[1] if path[-2] == "out" else node[0])
            return (rng.randn(*node) / np.sqrt(fan_in)).astype(np.float32)
        std = 0.05 if path[-1] == "bias" else 0.5
        return (std * rng.randn(*node)).astype(np.float32)

    return build(shapes, ())


@functools.lru_cache(maxsize=None)
def _stage(kind: str):
    """(kind, model dict, JAX stage, JAX-layout params, port stage, port
    params), built once per kind."""
    d = KINDS[kind]
    js, ts = j_build_stage(d), build_stage(d)
    jparams = _numpy_tree({"unet": U.jax_param_shapes(ts.unet_cfg,
                                                      ts.lowres_time)})
    return (kind, d, js, jparams, ts,
            imagen_params_from_jax(jparams, ts.unet_cfg, ts.lowres_time))


@pytest.fixture(scope="module", params=sorted(KINDS))
def stage(request):
    return _stage(request.param)


def _unet_args(kind: str, x: dict):
    t = np.array([1, 3])
    cond_drop = np.array([1.0, 0.0], np.float32)  # row 1: null text
    lowres_t = np.zeros((B,), np.int32) + 1 if kind == "sr" else None
    return (x["images"], t, x["text_embeds"], x["text_mask"], cond_drop,
            x.get("lowres_images"), lowres_t)


def _port_unet(tparams, ts, args, dtype=None):
    cfg = ts.unet_cfg if dtype is None else U.UNetConfig(
        **dict(vars(ts.unet_cfg), dtype=dtype))
    targs = [None if a is None else torch.from_numpy(np.asarray(a))
             for a in args]
    if targs[6] is not None:
        targs[6] = targs[6].long()
    with torch.no_grad():
        return U.efficient_unet(tparams["unet"], cfg, *targs)


def test_unet_output_matches_jax(stage):
    kind, _, js, jparams, ts, tparams = stage
    args = _unet_args(kind, _inputs(kind, seed=1))
    want = jax.jit(lambda p: js.apply(
        {"params": p}, *args, True, method=lambda m, *a: m.unet(*a)))(
        jparams)
    got = _port_unet(tparams, ts, args)
    assert got.shape == (B, SIZE, SIZE, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_unet_bf16_within_the_drift_bound():
    kind, d, _, jparams, ts, tparams = _stage("base")
    js = j_build_stage(dict(d, dtype="bfloat16"))
    args = _unet_args(kind, _inputs(kind, seed=1))
    want = np.asarray(jax.jit(lambda p: js.apply(
        {"params": p}, *args, True, method=lambda m, *a: m.unet(*a)))(
        jparams))
    got = _port_unet(tparams, ts, args, dtype=torch.bfloat16).numpy()
    err = np.abs(got - want).max()
    assert err <= 2.0 ** -4 * np.abs(want).max(), err


def _jax_draws(js, jparams, kind: str, x: dict, key) -> dict:
    """The loss's four draws from ``key`` as JAX's stage takes them."""
    dc = js.diff_cfg
    rng = js.apply({"params": jparams}, method=lambda m: m.make_rng(
        "diffusion"), rngs={"diffusion": key})
    t_rng, n_rng, cfg_rng, aug_rng = jax.random.split(rng, 4)
    draws = {"t": np.asarray(jax.random.randint(t_rng, (B,), 0,
                                                dc.timesteps)),
             "noise": np.asarray(jax.random.normal(
                 n_rng, x["images"].shape, jnp.float32)),
             "cond_drop": np.asarray((jax.random.uniform(cfg_rng, (B,))
                                      >= dc.cond_drop_prob).astype(
                                          jnp.float32))}
    if kind == "sr":
        draws["aug_noise"] = np.asarray(jax.random.normal(
            aug_rng, x["lowres_images"].shape, jnp.float32))
    return draws


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_stage_loss_and_grads_match_jax(case):
    kind, knobs = LOSSES[case]
    _, d, _, jparams, _, tparams = _stage(kind)
    js, ts = j_build_stage(dict(d, **knobs)), build_stage(dict(d, **knobs))
    x = _inputs(kind, seed=2)
    key = jax.random.PRNGKey(5)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: js.apply(
        {"params": p}, x["images"], x["text_embeds"], x["text_mask"],
        x.get("lowres_images"), deterministic=False,
        rngs={"diffusion": key})))(jparams)
    draws = {k: torch.from_numpy(v.copy()) for k, v in
             _jax_draws(js, jparams, kind, x, key).items()}
    draws["t"] = draws["t"].long()
    leaves = [p.clone().requires_grad_(True)
              for _, p in tree_leaves_with_path(tparams)]
    params = _rebuild(tparams, leaves)
    xt = _torch(x)
    got = ts.loss(params, xt["images"], xt["text_embeds"], xt["text_mask"],
                  xt.get("lowres_images"), deterministic=False, **draws)
    assert abs(float(got.detach()) - float(loss)) <= 1e-5
    g = torch.autograd.grad(got, leaves)
    want = imagen_params_from_jax(jax.device_get(grads), ts.unet_cfg,
                                  ts.lowres_time)
    pairs = list(zip(tree_leaves_with_path(want), g))
    top = max(float(w.abs().max()) for (_, w), _ in pairs)
    for (path, w), gg in pairs:
        scale = float(w.abs().max())
        if path[-2:] == ("key", "bias"):
            # 0 in exact arithmetic (the softmax ignores a constant per
            # row): round-off on both sides, held at 1e-7 of the largest
            # grad (f32's epsilon)
            scale = 1e-2 * top
        np.testing.assert_allclose(gg.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * scale,
                                   err_msg="/".join(path))


def _rebuild(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return next(it)

    return walk(tree)


def test_sample_matches_jax_with_its_noises(stage):
    """CFG (guidance 5) and dynamic thresholding; the SR stage on the
    low-res images with its augmentation time."""
    kind, _, js, jparams, ts, tparams = stage
    x = _inputs(kind, seed=3)
    shape = (B, SIZE, SIZE, 3)
    key = jax.random.PRNGKey(9)
    want = jax.jit(lambda p: js.apply(
        {"params": p}, key, shape, x["text_embeds"], x["text_mask"],
        x.get("lowres_images"), method=js.sample))(jparams)
    rng, init_rng = jax.random.split(key)
    init = np.asarray(jax.random.normal(init_rng, shape, jnp.float32))
    steps = []
    for _ in range(ts.diff_cfg.timesteps):
        rng, sub = jax.random.split(rng)
        steps.append(np.asarray(jax.random.normal(sub, shape, jnp.float32)))
    xt = _torch(x)
    module = ImagenModule({"Model": dict(KINDS[kind], image_size=SIZE)})
    got = module.sample_images(
        tparams, B, xt["text_embeds"], xt["text_mask"],
        xt.get("lowres_images"), init_noise=torch.from_numpy(init.copy()),
        step_noises=torch.from_numpy(np.stack(steps)))
    assert got.shape == shape and float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_decay_mask_and_tree_checks_match_jax(stage):
    kind, _, js, jparams, ts, tparams = stage
    j_mask = jax.tree_util.tree_leaves(JOPT.decay_mask(jparams))
    j_paths = [tuple(k.key for k in path) for path, _ in
               jax.tree_util.tree_flatten_with_path(jparams)[0]]
    t_mask = [m for _, m in tree_leaves_with_path(TOPT.decay_mask(tparams))]
    t_paths = [p for p, _ in tree_leaves_with_path(tparams)]
    assert sorted(zip(j_paths, j_mask)) == sorted(zip(t_paths, t_mask))
    assert ("unet", "null_text") in t_paths and \
        ("unet", "lowres_time_mlp", "kernel") in t_paths if kind == "sr" \
        else ("unet", "lowres_time_mlp", "kernel") not in t_paths
    x = _inputs(kind)
    init = jax.eval_shape(lambda k: js.init(
        {"params": k, "diffusion": k}, x["images"], x["text_embeds"],
        x["text_mask"], x.get("lowres_images"), deterministic=True),
        jax.random.PRNGKey(0))
    check_imagen_tree(meta.unbox(init["params"]), ts.unet_cfg,
                      ts.lowres_time)
    check_imagen_tree(tparams, ts.unet_cfg, ts.lowres_time,
                      jax_layout=False)
    with pytest.raises(ValueError, match="conv_in"):
        bad = {"unet": dict(jparams["unet"], conv_in={
            "kernel": np.zeros((3, 3, 5, 16)), "bias": np.zeros(16)})}
        check_imagen_tree(bad, ts.unet_cfg, ts.lowres_time)
    # the layouts: HWIO -> OHWI, DenseGeneral [c, h, d] -> [c, h*d]
    conv = jparams["unet"]["conv_in"]["kernel"]
    np.testing.assert_array_equal(
        tparams["unet"]["conv_in"]["kernel"].numpy(),
        np.transpose(conv, (3, 0, 1, 2)))
    q = jparams["unet"]["mid_xattn"]["attn"]["query"]["kernel"]
    assert tuple(tparams["unet"]["mid_xattn"]["attn"]["query"][
        "kernel"].shape) == (q.shape[0], q.shape[1] * q.shape[2])
    seeded = ImagenModule({"Model": dict(KINDS[kind])}).init_params(0, "cpu")
    assert [(p, tuple(v.shape)) for p, v in tree_leaves_with_path(seeded)] \
        == [(p, tuple(v.shape)) for p, v in tree_leaves_with_path(tparams)]


# -------------------------------------------------------------- datasets
def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_synthetic_dataset_matches_jax_and_the_registry():
    for lowres in (None, 4):
        kw = dict(num_samples=5, image_size=8, lowres_size=lowres,
                  text_len=6, text_embed_dim=10, seed=3)
        t_ds, j_ds = TD.SyntheticImagenDataset(**kw), \
            JD.SyntheticImagenDataset(**kw)
        assert len(t_ds) == len(j_ds) == 5
        for i in range(5):
            got, want = t_ds[i], j_ds[i]
            assert sorted(got) == sorted(want)
            for k in want:
                _same(got[k], want[k], f"{i} {k}")
    ds = build_dataset({"Train": {"dataset": {
        "name": "SyntheticImagenDataset", "num_samples": 3,
        "text_embed_dim": 12}}}, "Train", seq_length=1024, vocab_size=50304)
    assert isinstance(ds, TD.SyntheticImagenDataset) and \
        ds[0]["text_embeds"].shape == (16, 12)


def test_imagen_dataset_matches_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.RandomState(0)
    n, tlen, dim = 3, 4, 6
    lines = []
    for i in range(n):
        arr = rng.randint(0, 256, (12, 10, 3)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        lines.append(f"caption {i}\t"
                     + base64.b64encode(buf.getvalue()).decode())
    tsv = tmp_path / "train.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    np.save(tmp_path / "t5_embeds.npy",
            rng.randn(n, tlen, dim).astype(np.float32))
    np.save(tmp_path / "t5_mask.npy", (rng.rand(n, tlen) > 0.3).astype(
        np.int32))
    kw = dict(embeds_prefix=str(tmp_path / "t5"), image_size=8,
              lowres_size=4)
    t_ds = TD.ImagenDataset(str(tsv), **kw)
    os.remove(str(tsv) + ".idx.npy")   # each side builds its own index
    j_ds = JD.ImagenDataset(str(tsv), **kw)
    assert len(t_ds) == len(j_ds) == n
    for i in range(n):
        got, want = t_ds[i], j_ds[i]
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k], f"{i} {k}")
    # the cached index is read back
    assert list(TD.ImagenDataset(str(tsv), **kw).offsets) == \
        list(t_ds.offsets)


# ------------------------------------------------- module, trainer, sampler
#: the recipe through tools.train on the CPU at the tiny size
TRAIN_TINY = ["Model.dim=16", "Model.dim_mults=[1, 2]",
              "Model.num_attn_heads=2", "Model.cond_dim=16",
              "Model.text_embed_dim=8", "Model.num_latents=4",
              "Model.layer_attns=[False, True]",
              "Model.layer_cross_attns=[False, True]", "Model.timesteps=4",
              "Model.dtype=float32", "Model.image_size=16",
              "Global.global_batch_size=2", "Global.local_batch_size=2",
              "Engine.max_steps=3", "Engine.logging_freq=1",
              "Engine.save_load.save_steps=0",
              "Data.Train.dataset.name=SyntheticImagenDataset",
              "Data.Train.dataset.image_size=16",
              "Data.Train.dataset.text_embed_dim=8",
              "Data.Train.dataset.num_samples=6",
              "Data.Train.loader.batch_size=2"]


def test_three_step_fit_through_tools_train(tmp_path):
    from fleetx_tpu_torch.core.checkpoint import load_params
    from fleetx_tpu_torch.tools import train as T

    cfg = T.load_config(SR_YAML, TRAIN_TINY + [
        "Data.Train.dataset.lowres_size=8", "Engine.save_load.save_steps=3",
        f"Engine.save_load.output_dir={tmp_path}"])
    engine, losses = T.run(cfg, device="cpu")
    assert type(engine.module).__name__ == "ImagenModule"
    assert engine.module.spec_family == "imagen"
    assert engine.module.stage.unet_cfg.lowres_cond
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert all(np.isfinite(h["grad_norm"]) for h in engine.history)
    # an untrained net's eps-MSE: about 1 plus its output's variance
    assert 0.5 < losses[0] < 3.0
    engine.module.check_params(load_params(str(tmp_path)))
    # the step's draws follow the seed and the step: the same step twice
    # gives the same loss
    batch = engine.to_device(next(iter(
        build_dataloader(cfg["Data"], "Train", batch_size=2))))
    with torch.no_grad():
        a = engine.module.training_loss(engine.params, batch, 1, 4)[0]
        b = engine.module.training_loss(engine.params, batch, 1, 4)[0]
        c = engine.module.training_loss(engine.params, batch, 1, 5)[0]
        v = engine.module.validation_loss(engine.params, batch)[0]
    assert float(a) == float(b) and float(a) != float(c)
    assert np.isfinite(float(v))
    # tools.eval's Data.Eval path on the saved checkpoint
    from fleetx_tpu_torch.tools import eval as EV

    ev_cfg = EV.load_config(SR_YAML, TRAIN_TINY + [
        "Data.Train.dataset.lowres_size=8",
        f"Engine.save_load.ckpt_dir={tmp_path}", "Engine.eval_iters=1",
        "Data.Eval.dataset.name=SyntheticImagenDataset",
        "Data.Eval.dataset.image_size=16", "Data.Eval.dataset.lowres_size=8",
        "Data.Eval.dataset.text_embed_dim=8",
        "Data.Eval.dataset.num_samples=2",
        "Data.Eval.loader.batch_size=2"])
    loss = EV.data_eval(ev_cfg, device="cpu")
    ds = TD.SyntheticImagenDataset(num_samples=2, image_size=16,
                                   lowres_size=8, text_embed_dim=8)
    eval_batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in (0, 1)]))
                  for k in ds[0]}
    with torch.no_grad():
        want = engine.module.validation_loss(engine.params, eval_batch)[0]
    assert loss == pytest.approx(float(want), rel=1e-5)


def test_cascade_sampler_chains_base_into_sr(tmp_path):
    from fleetx_tpu_torch.tasks.imagen import generate as GEN

    tiny = [o for o in TRAIN_TINY if o.startswith("Model.")]
    out = tmp_path / "samples.npy"
    rc = GEN.main(["-c", BASE_YAML, "--device", "cpu",
                   "-o", "Generation.batch_size=2",
                   "-o", f"Generation.output_path={out}"]
                  + [a for o in tiny for a in ("-o", o)])
    assert rc == 0
    base = np.load(out)
    assert base.shape == (2, 16, 16, 3) and np.abs(base).max() <= 1.0
    # the SR stage's config as the driver reads it: a YAML on the recipe
    sr_yaml = tmp_path / "sr_tiny.yaml"
    model = {k.split(".", 1)[1]: yaml.safe_load(v) for k, v in
             (o.split("=", 1) for o in tiny)}
    sr_yaml.write_text(yaml.safe_dump({"_base_": SR_YAML, "Model": dict(
        model, image_size=32)}))
    cfg = GEN.load_config(BASE_YAML, tiny + ["Generation.batch_size=2"])
    cfg["Generation"]["stage_configs"] = [str(sr_yaml)]
    images = GEN.run(cfg, device="cpu")
    assert tuple(images.shape) == (2, 32, 32, 3)
    assert torch.isfinite(images).all() and float(images.abs().max()) <= 1.0
    mod = build_module({"Model": {"module": "ImagenModule",
                                  "preset": "sr256"}})
    assert isinstance(mod, ImagenModule) and mod.model_cfg.dim_mults == (
        1, 2, 4, 8) and mod.stage.lowres_time
