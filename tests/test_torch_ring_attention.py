"""Port parity: ring attention at ring size 1
(``fleetx_tpu_torch/ops/ring_attention.py``).

The same numpy inputs go through the JAX ``ring_attention`` on a
one-device ``seq`` mesh (``build_mesh({"seq_degree": 1}, ...)``; the
Pallas kernels in interpret mode on the flash route) and through the
port's ``ring_attention`` on CPU tensors (the kernels' plain versions),
forward and grads, on both routes: the flash route (a local block the
kernels take) and the einsum streaming route with ``kv_chunk`` (a block
they reject). The online-lse merge and the global-lse backward that the
later ring steps rely on are checked directly by splitting the keys into
two blocks.

Tolerance: f32 rtol/atol 1e-5 (every product in f32 on both sides; only
the summation order differs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fleetx_tpu.ops.ring_attention import ring_attention as j_ring
from fleetx_tpu.parallel.mesh import build_mesh
from fleetx_tpu_torch.ops import flash_attention as FA
from fleetx_tpu_torch.ops import ring_attention as RA

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

F32 = dict(rtol=1e-5, atol=1e-5)

#: name -> (shape [b, s, n, d], causal, kv_chunk, route the port takes)
CASES = {"flash": ((1, 256, 2, 64), True, None, "flash"),
         "flash_kv_chunk_inert": ((1, 128, 1, 128), True, 64, "flash"),
         "einsum_chunked": ((2, 64, 2, 32), True, 16, "einsum"),
         "einsum_noncausal": ((1, 96, 2, 32), False, 32, "einsum")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ring_size_one_matches_jax(devices8, case):
    shape, causal, kv_chunk, route = CASES[case]
    rng = np.random.RandomState(len(case))
    q, k, v, g = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    assert RA.flash_ring_supported(torch.from_numpy(q), 1) == \
        (route == "flash" and causal)

    def j_loss(q, k, v):
        out = j_ring(q, k, v, causal=causal, kv_chunk=kv_chunk)
        return (out * g).sum(), out

    mesh = build_mesh({"seq_degree": 1}, devices=devices8[:1])
    with mesh:
        (_, j_out), j_grads = jax.jit(jax.value_and_grad(
            j_loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = RA.ring_attention(tq, tk, tv, causal=causal, ring=1,
                            kv_chunk=kv_chunk)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **F32)
    for got, want in zip((tq.grad, tk.grad, tv.grad), j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_flash_route_runs_the_split_pair_against_the_saved_lse(monkeypatch):
    """The flash route's backward is the split dq + dk/dv pair (never the
    fused kernel), fed the forward's lse; on CPU tensors no launch counts."""
    calls = []
    for name in ("bwd_plain", "bwd_dq_plain", "bwd_dkv_plain"):
        fn = getattr(FA, name)
        monkeypatch.setattr(FA, name, lambda *a, _fn=fn, _n=name: (
            calls.append(_n), _fn(*a))[1])
    for fn in (FA.fwd_call, FA.bwd_call, FA.bwd_dq_call, FA.bwd_dkv_call):
        fn.launches = 0
    rng = np.random.RandomState(3)
    q, k, v = (torch.tensor(rng.randn(1, 128, 2, 64).astype(np.float32),
                            requires_grad=True) for _ in range(3))
    RA.ring_attention(q, k, v, ring=1).sum().backward()
    assert calls == ["bwd_dq_plain", "bwd_dkv_plain"]
    assert all(fn.launches == 0 for fn in (FA.fwd_call, FA.bwd_call,
                                           FA.bwd_dq_call, FA.bwd_dkv_call))


def test_two_key_blocks_merge_and_split_backward_against_global_lse():
    """What the ring's later steps compute, on one rank: attention over
    keys [0, 2s) equals the online-lse merge of the two key blocks'
    ``(out, lse)``; each block's split backward against the GLOBAL lse
    gives that block's dk/dv and its share of dq exactly."""
    rng = np.random.RandomState(9)
    bh, s, d = 2, 128, 64
    q, do = (torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(bh, 2 * s, d).astype(np.float32))
            for _ in range(2))
    scale = d ** -0.5
    full_out, full_lse = FA.fwd_plain(q, k, v, 0, scale, causal=False)
    blocks = [slice(0, s), slice(s, 2 * s)]
    o_acc, l_acc = None, None
    for blk in blocks:
        o_t, l_t = FA.fwd_call(q, k[:, blk].contiguous(),
                               v[:, blk].contiguous(), 0, scale, False)
        if o_acc is None:
            o_acc, l_acc = o_t.float(), l_t
        else:
            o_acc, l_acc = RA.merge_blocks(o_acc, l_acc, o_t, l_t)
    np.testing.assert_allclose(o_acc.numpy(), full_out.numpy(), **F32)
    np.testing.assert_allclose(l_acc.numpy(), full_lse.numpy(), **F32)

    delta = (full_out * do).sum(-1)
    want_dq, want_dk, want_dv = FA.bwd_plain(q, k, v, do, full_lse, delta,
                                             0, scale, causal=False)
    dq = torch.zeros_like(q)
    for blk in blocks:
        args = (q, k[:, blk].contiguous(), v[:, blk].contiguous(), do,
                l_acc, delta, 0, scale, False)
        dq += FA.bwd_dq_call(*args)
        dk, dv = FA.bwd_dkv_call(*args)
        np.testing.assert_allclose(dk.numpy(), want_dk[:, blk].numpy(),
                                   **F32)
        np.testing.assert_allclose(dv.numpy(), want_dv[:, blk].numpy(),
                                   **F32)
    np.testing.assert_allclose(dq.numpy(), want_dq.numpy(), **F32)


def test_ring_over_more_than_one_rank_raises_naming_item_12():
    q = torch.zeros((1, 256, 2, 64))
    for use_flash in (None, False):
        with pytest.raises(NotImplementedError, match="item 12"):
            RA.ring_attention(q, q, q, ring=2, use_flash=use_flash)


def test_kv_chunk_must_divide_the_local_block():
    q = torch.zeros((1, 96, 2, 32))
    with pytest.raises(ValueError, match="must divide"):
        RA.ring_attention(q, q, q, kv_chunk=64)
