"""Port parity: the split page walk of the paged decode kernel.

The CUDA kernel (``fleetx_tpu_torch/csrc/paged_attention.cu``) splits each
request's table into chunks of ``pages_per_chunk`` entries, computes one
unnormalised partial per chunk and merges the partials in chunk order.
``paged_call_plain_split`` is that split in plain PyTorch. Here the same
numpy inputs, made from a seed, go through it, through the unsplit plain
version ``paged_call_plain`` and through the JAX package's Pallas kernel
``_paged_call`` (interpret mode on the CPU, as its own tests run it);
``chip_smoke.py`` holds the CUDA kernel to both plain versions on the card.

Tolerance: ``acc`` / ``m`` / ``l`` within rtol = atol = 1e-5 in f32 and
bf16. Every side casts q and k to f32 before any arithmetic, so only the
order of the f32 sums differs (and the merge's ``exp(m_c - m)`` rescale,
which is exact when the chunk holds the running maximum).

The planner (``plan_split``) is checked over every geometry the gate
admits: each plan's shared memory fits the card's 227 KB a block, and a
CPU tensor never gets the CUDA route.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fleetx_tpu.ops import paged_attention as JPA
from fleetx_tpu_torch.ops import paged_attention as PA

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

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

#: name → (B, nh, hd, page_size, pages per request, pool pages, lens).
#: "base": crosses page boundaries (13), a lone first position (0), an
#: inactive row (-1), the last slot of a page (7), the full table (23 =
#: P·ps − 1); row 0's table entries 2-3 are skipped, so a chunk of 1 or 2
#: pages holds only skipped pages, and short rows leave chunks wholly
#: beyond lens
GEOMETRIES = {
    "base": (5, 4, 16, 4, 6, 20, [13, 0, -1, 7, 23]),
    "ps1": (3, 2, 16, 1, 9, 30, [8, 3, -1]),
    "ps16_hd8": (2, 3, 8, 16, 3, 8, [47, 20]),
    "hd64_nh3": (3, 3, 64, 4, 5, 16, [19, 5, -1]),
    "hd256_nh1": (2, 1, 256, 4, 4, 10, [15, 6]),
    "nh16": (2, 16, 8, 4, 4, 10, [15, 9]),
    "b1": (1, 4, 16, 4, 6, 8, [23]),
}


def _case(name: str, seed: int = 0):
    """q, pools, localized tables (-1 = skipped) and lens as numpy."""
    B, nh, hd, ps, P, pages, lens = GEOMETRIES[name]
    rng = np.random.RandomState(seed)
    q = rng.randn(B, nh, hd).astype(np.float32)
    pk = rng.randn(pages, ps, nh, hd).astype(np.float32)
    pv = rng.randn(pages, ps, nh, hd).astype(np.float32)
    tables = np.full((B, P), -1, np.int32)
    free = list(rng.permutation(np.arange(pages)))
    for b, n in enumerate(lens):
        used = -(-(n + 1) // ps) if n >= 0 else 0
        tables[b, :used] = [free.pop() for _ in range(used)]
    if name == "base":
        tables[0, 2:4] = -1
    return q, pk, pv, tables, np.asarray(lens, np.int32)


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrs]


_pallas_cache = {}


def _pallas(name: str, dtype_name: str):
    """``_paged_call``'s triple on the case, computed once per case."""
    key = (name, dtype_name)
    if key not in _pallas_cache:
        jd = DTYPES[dtype_name][0]
        arrs = [jnp.asarray(a).astype(jd) if a.dtype == np.float32
                else jnp.asarray(a) for a in _case(name)]
        _pallas_cache[key] = [np.asarray(x) for x in JPA._paged_call(*arrs)]
    return _pallas_cache[key]


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_plain_split_matches_plain_and_pallas_kernel(name, dtype_name):
    """The split at 1, 2 and more pages a chunk than the table holds,
    against the unsplit plain version and the Pallas kernel; inactive
    rows normalise to exact zeros."""
    P = GEOMETRIES[name][4]
    lens = GEOMETRIES[name][6]
    tq, tk, tv, tt, tl = _torch(_case(name), DTYPES[dtype_name][1])
    plain = PA.paged_call_plain(tq, tk, tv, tt, tl)
    pallas = _pallas(name, dtype_name)
    for ppc in (1, 2, P + 1):
        split = PA.paged_call_plain_split(tq, tk, tv, tt, tl, ppc)
        for what, s, p, j in zip(("acc", "m", "l"), split, plain, pallas):
            assert s.dtype == torch.float32, what
            np.testing.assert_allclose(s.numpy(), p.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{what} {ppc}")
            np.testing.assert_allclose(s.numpy(), j, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what} {ppc} pallas")
        out = PA._normalize(split[0], split[2], torch.float32)
        for b, n in enumerate(lens):
            if n < 0:
                assert (out[b] == 0).all() and (split[2][b] == 0).all()
                assert (split[1][b] == -1e30).all()


def test_chunks_of_skipped_pages_and_bad_ids_are_empty_partials():
    """A chunk whose pages are all skipped, or whose ids lie outside the
    pool, adds nothing: the split equals the plain version, and a row
    whose every page is skipped is the empty triple."""
    q, pk, pv, tables, lens = _case("base", seed=1)
    tables[4, 1] = pk.shape[0] + 3           # an id beyond the pool
    tables[1, 0] = -1                        # row 1's only page skipped
    tq, tk, tv, tt, tl = _torch([q, pk, pv, tables, lens], torch.float32)
    plain = PA.paged_call_plain(tq, tk, tv, tt, tl)
    for ppc in (1, 2, 3):
        split = PA.paged_call_plain_split(tq, tk, tv, tt, tl, ppc)
        for s, p in zip(split, plain):
            np.testing.assert_allclose(s.numpy(), p.numpy(), rtol=1e-5,
                                       atol=1e-5)
        assert (split[0][1] == 0).all() and (split[2][1] == 0).all()
        assert (split[1][1] == -1e30).all()


def _admitted_geometries():
    for hd in range(8, 257, 8):
        for nh in (1, 3, 16, 64, 128):
            for ps in (1, 4, 16, 64, 256, 1024):
                for dtype in (torch.float32, torch.bfloat16):
                    for batch, ppr in ((1, 1), (16, 64), (64, 512)):
                        yield batch, nh, hd, ps, ppr, dtype


def test_plan_fits_every_admitted_geometry():
    """Every geometry the gate admits gets a CUDA plan whose block fits:
    shared memory within 227 KB, a worker for every head of a block, a
    tile within ``TILE_BYTES`` (or one row of one head) and a TMA box,
    head rows of whole 16-byte vectors, a few pages a chunk."""
    cuda = torch.device("cuda")
    n = 0
    for batch, nh, hd, ps, ppr, dtype in _admitted_geometries():
        assert PA.paged_attention_supported(
            num_heads=nh, head_dim=hd, page_size=ps, pages_per_req=ppr,
            dtype=dtype)
        plan = PA.plan_split(batch=batch, num_heads=nh, head_dim=hd,
                             page_size=ps, pages_per_req=ppr, dtype=dtype,
                             device=cuda)
        item = dtype.itemsize
        assert plan.route == "bulk_split"
        assert plan.smem_bytes <= PA.SMEM_LIMIT
        assert plan.smem_bytes == PA.smem_bytes(
            plan.head_block, plan.rows_per_tile, hd, item, plan.slots,
            plan.pages_per_chunk)
        assert 1 <= plan.head_block <= nh
        # every head of a block has a worker of group_lanes lanes in each
        # consumer group
        assert plan.head_block * PA.group_lanes(hd, item) \
            <= PA.GROUP_THREADS
        assert 1 <= plan.rows_per_tile <= min(ps, PA.MAX_BOX)
        tile = plan.rows_per_tile * plan.head_block * hd * item
        assert tile <= PA.TILE_BYTES or plan.head_block == 1 \
            and plan.rows_per_tile == 1
        assert (plan.head_block * hd * item) % 16 == 0
        assert 1 <= plan.pages_per_chunk <= PA.MAX_CHUNK_PAGES
        chunks, hblks, b = plan.grid(batch, nh, ppr)
        assert b == batch and hblks < 65536 and chunks * plan.pages_per_chunk \
            >= ppr > (chunks - 1) * plan.pages_per_chunk
        n += 1
    assert n == 32 * 5 * 6 * 2 * 3


def _active_blocks(plan, lens, nh, ps, ppr):
    """Blocks that walk pages: per request, the chunks up to lens."""
    span = plan.pages_per_chunk * ps
    chunks = plan.grid(1, nh, ppr)[0]
    hblks = plan.grid(1, nh, ppr)[1]
    return sum(min(min(n, ppr * ps - 1) // span + 1, chunks) * hblks
               for n in lens if n >= 0)


def test_345m_plan_covers_every_sm():
    """At the 345M serving geometry in bf16 the split puts a working
    block on each of the H100's 132 SMs for the ragged phase-1 lens and
    for the full pool, with no block walking more than 8 pages (4 for
    each of its consumer groups)."""
    plan = PA.plan_split(batch=16, num_heads=16, head_dim=64, page_size=16,
                         pages_per_req=64, dtype=torch.bfloat16,
                         device=torch.device("cuda"))
    assert (plan.head_block, plan.rows_per_tile, plan.pages_per_chunk,
            plan.slots) == (4, 16, 8, 2)
    ragged = [-1, 0, 15, 16, 1023, 511, 100, 777, 256, 31, 1000, 64, 900,
              5, 300, 1022]
    for lens in (ragged, [511] * 16):
        assert _active_blocks(plan, lens, 16, 16, 64) >= PA.H100_SMS
    # two blocks an SM fit the card's shared memory
    assert 2 * plan.smem_bytes <= 228 * 1024


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plan_never_gives_a_cpu_tensor_the_cuda_route(device):
    plan = PA.plan_split(batch=16, num_heads=16, head_dim=64, page_size=16,
                         pages_per_req=64, dtype=torch.bfloat16,
                         device=torch.device(device))
    assert plan.route == "plain"
    q = torch.empty((16, 16, 64), dtype=torch.bfloat16, device=device)
    pool = torch.empty((4, 16, 16, 64), dtype=torch.bfloat16, device=device)
    tables = torch.empty((16, 64), dtype=torch.int32, device=device)
    assert PA._plan_for(q, pool, tables).route == "plain"


class _Entry:
    """Stands in for the C entry point: records its arguments and
    reports success."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def test_launch_passes_the_plan_to_the_entry_point(monkeypatch):
    """``_launch`` hands the kernel its ten pointers (inputs, outputs,
    workspace, counters), the geometry, the plan, the dtype code, the
    scale and the stream (meta tensors: shapes without data), and reuses
    one workspace per geometry."""
    entry = _Entry()
    monkeypatch.setattr(PA, "_kernel_fn", lambda: entry)
    monkeypatch.setattr(PA, "_stream", lambda t: 7)
    monkeypatch.setattr(PA, "_workspaces", {})
    q = torch.empty((16, 14, 64), dtype=torch.bfloat16, device="meta")
    pool = torch.empty((513, 16, 14, 64), dtype=torch.bfloat16,
                       device="meta")
    tables = torch.empty((16, 64), dtype=torch.int32, device="meta")
    lens = torch.empty((16,), dtype=torch.int32, device="meta")
    plan = PA.plan_split(batch=16, num_heads=14, head_dim=64, page_size=16,
                         pages_per_req=64, dtype=torch.bfloat16,
                         device=torch.device("cuda"))
    for _ in range(2):
        acc, m, l = PA._launch(q, pool, pool, tables, lens, plan)
    assert acc.shape == (16, 14, 64) and m.shape == l.shape == (16, 14)
    assert len(entry.calls) == 2
    args = entry.calls[0]
    assert len(args) == 23
    assert args[10:21] == (16, 14, 64, 513, 16, 64, plan.head_block,
                           plan.rows_per_tile, plan.pages_per_chunk,
                           plan.slots, 1)
    assert args[21] == pytest.approx(0.125) and args[22] == 7
    (key, (ws, counters)), = PA._workspaces.items()
    chunks, hblks, _ = plan.grid(16, 14, 64)
    assert plan.head_block == 4 and hblks == 4  # 4 does not divide 14
    assert ws.numel() == 16 * hblks * chunks * plan.head_block * (64 + 2)
    assert counters.numel() == 16 * hblks and counters.dtype == torch.int32
