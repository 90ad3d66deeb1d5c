"""The port's CUDA kernels on the card: each against the CPU path (the plain
PyTorch versions, which ``tests/test_torch_dataplane.py`` and
``tests/test_torch_model_kernels.py`` hold against the JAX package) at
ragged sizes, the wrappers' refusals, the launch counters, a small refresh
round, a small partitioned incremental scenario and a small MQO-merged
scenario card against CPU, schema inference on the card (no launch), and
small-model serving (dense and Mamba-2) and training steps card against
CPU, and a small multi-host scenario on forked hosts that use the card (in
a fresh interpreter) against the CPU. The data-plane kernels are compared bitwise; RMSNorm, the flash forward
and the SSD scan within the JAX kernel tests' tolerances (1e-5 / 2e-2,
2e-5 / 3e-2 and 2e-4 / 5e-2 in f32 / bf16), the flash backward within 2e-4
in f32 (the JAX gradient test's) and 3e-2 in bf16 (one bf16 rounding of
each gradient, as the forward's); each flash case also checks which kernel
it took (bf16: the tensor cores; f32: the CUDA cores), and the forward, the
dq and the dk/dv backward must repeat bitwise. Needs a card; every test
skips without one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import repro_torch.core as core
import repro_torch.mv as mv
from repro_torch import configs, models, serve
from repro_torch.kernels import flash_attention_bwd, flash_attention_fwd, ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.mv import dataplane as dp
from repro_torch.mv import ir as mvir
from repro_torch.mv import tableops as T

pytestmark = pytest.mark.cuda

SIZES = [1, 255, 256, 257, 100_003]
I64MAX = np.iinfo(np.int64).max
I64MIN = np.iinfo(np.int64).min


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def same_bits(cpu_out, cuda_out, ctx=""):
    cpu_out = cpu_out if isinstance(cpu_out, tuple) else (cpu_out,)
    cuda_out = cuda_out if isinstance(cuda_out, tuple) else (cuda_out,)
    for a, b in zip(cpu_out, cuda_out):
        b = b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, ctx
        assert a.numpy().tobytes() == b.numpy().tobytes(), ctx


def rand(n, dtype, seed, scale=3.0):
    a = np.random.default_rng(seed).standard_normal(n) * scale
    return torch.from_numpy(a.astype(dtype))


@pytest.mark.parametrize("n", SIZES)
def test_filter_kernel_matches_cpu(dev, n):
    """Views ``col[k:]`` at every element offset within 16 bytes: the
    vector kernel after a head of rows compared one by one, where at least
    one 16-byte vector follows the head; the scalar kernel
    (``filter_gt/scalar``) only where none does. NaN and +-inf rows, and
    lengths that leave a tail of rows past the last 16-byte vector."""
    for dtype in (np.float32, np.float64, np.int64):
        col = rand(n + 3, dtype, n, scale=100)
        if dtype is not np.int64:
            col[: min(n, 3)] = torch.tensor([np.nan, np.inf, -np.inf][: min(n, 3)])
            col[-2:] = torch.tensor([np.nan, -np.inf])
        on_card = col.to(dev)
        for k in range(4):
            view, view_card = col[k:k + n], on_card[k:k + n]
            scalar = dp.filter_head(view_card.data_ptr(), view_card.element_size(), n) is None
            assert scalar == (n * col.element_size() < 16 + (-k * col.element_size()) % 16)
            for thr in (0.1, -0.3):
                dp.reset_launches()
                same_bits(dp.filter_mask(view, thr), dp.filter_mask(view_card, thr),
                          f"{dtype} k={k} {thr}")
                assert dp.launches["filter_gt"] == 1
                assert dp.variant_launches["filter_gt/scalar"] == scalar, (dtype, k)


@pytest.mark.parametrize("n", SIZES)
def test_map_kernel_matches_cpu_every_dtype_pair(dev, n):
    pairs = [(np.float32, np.float32), (np.float32, np.float64),
             (np.float64, np.float32), (np.float64, np.float64),
             (np.float64, np.int64), (np.float32, np.int64), (np.int64, np.int64),
             (np.int64, np.float32), (np.float32, None), (np.float64, None),
             (np.int64, None)]
    for adt, bdt in pairs:
        a = rand(n, adt, n, 50)
        b = None if bdt is None else rand(n, bdt, n + 1, 50)
        got = dp.map_derived(a.to(dev), None if b is None else b.to(dev))
        same_bits(dp.map_derived(a, b), got, f"{adt} {bdt}")


@pytest.mark.parametrize("n", SIZES)
def test_encode_kernel_matches_cpu(dev, n):
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.integers(-3, 4, n).astype(np.int64))
    w[: min(n, 4)] = torch.tensor([1 << 45, I64MAX, I64MIN, -7][: min(n, 4)])
    for dtype in (np.float32, np.float64):
        v = rand(n, dtype, n, 100)
        for weights in (None, w):
            got = dp.fixed_point_encode(
                v.to(dev), None if weights is None else weights.to(dev))
            same_bits(dp.fixed_point_encode(v, weights), got, f"{dtype}")


def test_map_and_encode_kernels_at_int64_min_nan_inf_and_out_of_range(dev):
    """The card's MAP takes an int64 column's |x| in wrapping int64, so
    softsign(INT64_MIN) is 1.0 as in numpy; its encode gives INT64_MIN
    where rint(v * 2^16) is NaN or outside [-2^63, 2^63), as x86 numpy
    does, not the card's saturated conversion."""
    x = torch.tensor([I64MIN, I64MIN + 1, I64MAX, -1, 0, 7])
    a = torch.tensor([1.5, -2.0, 0.0, 3e38, -0.0, 1.0])
    for args in ((x, None), (a, x), (a.double(), x), (x, x), (x, a)):
        got = dp.map_derived(*(None if t is None else t.to(dev) for t in args))
        same_bits(dp.map_derived(*args), got, str([getattr(t, "dtype", None) for t in args]))
    assert dp.map_derived(x.to(dev), None)[0].item() == 1.0
    v = torch.tensor([np.nan, np.inf, -np.inf, 2.0**47, -2.0**47, 1.5e14, -1.5e14,
                      3e38, 1e300, -1e300, 1.0], dtype=torch.float64)
    w = torch.arange(-5, len(v) - 5)
    for vals in (v, v[:8].float()):
        for weights in (None, w[:len(vals)]):
            got = dp.fixed_point_encode(vals.to(dev),
                                        None if weights is None else weights.to(dev))
            same_bits(dp.fixed_point_encode(vals, weights), got, f"{vals.dtype}")
    assert dp.fixed_point_encode(v.to(dev)).tolist() == [I64MIN] * 10 + [65536]


# Index sizes for the probe's search tree (tests/test_torch_probe_tree.py
# holds its CPU model at the same ones): one leaf of TREE_KEYS keys and its
# edges, the edges of every leaf count that fills a level, and indexes
# whose lower levels no longer fit in shared memory.
B, FAN = dp.TREE_KEYS, dp.TREE_FAN
TREE_SIZES = sorted({1, 2, B - 1, B, B + 1, 4097, 100_003, 1_000_003,
                     *(FAN**k + d for k in (1, 2, 3) for d in (-1, 0, 1)),
                     *(B * FAN**k + d for k in (1, 2, 3) for d in (-1, 0, 1))})


@pytest.mark.parametrize("n", SIZES)
def test_probe_kernel_matches_cpu(dev, n):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(-50, 50, 3 * n + 2).astype(np.int64))
    uniq, first = dp.first_occurrence(keys)
    probe = torch.from_numpy(rng.integers(-60, 60, n).astype(np.int64))
    probe[: min(n, 2)] = torch.tensor([I64MAX, I64MIN][: min(n, 2)])
    for u in (uniq, uniq[:1], torch.cat([uniq, torch.tensor([I64MAX])])):
        same_bits(dp.probe_sorted(u, probe),
                  dp.probe_sorted(u.to(dev), probe.to(dev)), f"L={len(u)}")
    same_bits(dp.first_occurrence(keys), dp.first_occurrence(keys.to(dev)))
    # The tree's sizes: an index with gaps of 1-3 holding INT64_MIN and
    # INT64_MAX (from two keys on), probed with both extremes, every key,
    # every key +- 1 and n random values; one view off 16 bytes.
    for L in TREE_SIZES:
        idx = -2 * L + np.cumsum(rng.integers(1, 4, L)).astype(np.int64)
        if L >= 2:
            idx[[0, -1]] = [I64MIN, I64MAX]
        with np.errstate(over="ignore"):
            pv = np.concatenate([[I64MIN, I64MAX], idx, idx - 1, idx + 1,
                                 rng.integers(-2 * L, 2 * L, n)])
        u, p = torch.from_numpy(idx), torch.from_numpy(pv)
        dp.reset_launches()
        same_bits(dp.probe_sorted(u, p), dp.probe_sorted(u.to(dev), p.to(dev)), f"L={L}")
        assert dp.launches["probe_sorted"] == 1
        assert dp.variant_launches["probe_sorted/build"] == (L > B), L
        if L > 1:
            u_off = torch.from_numpy(np.concatenate([[I64MIN], idx]))
            same_bits(dp.probe_sorted(u_off[1:], p),
                      dp.probe_sorted(u_off.to(dev)[1:], p.to(dev)), f"L={L} off 16 bytes")


@pytest.mark.parametrize("n", SIZES)
def test_hash_kernels_match_cpu(dev, n):
    """``hash64`` and ``pid_hist`` on uniform and Zipf-skewed keys, on both
    sides of the shared-memory histogram limit (P <= 8192)."""
    rng = np.random.default_rng(n)
    uniform = rng.integers(I64MIN, I64MAX, n, dtype=np.int64, endpoint=True)
    uniform[: min(n, 4)] = [I64MIN, I64MAX, -1, 0][: min(n, 4)]
    for keys in (uniform, rng.zipf(1.3, n).astype(np.int64)):
        k = torch.from_numpy(keys)
        dp.reset_launches()
        got = dp.hash64(k.to(dev))
        assert got.dtype == torch.uint64 and dp.launches["hash64"] == 1
        same_bits(dp.hash64(k).view(torch.int64), got.view(torch.int64))
        for P in (2, 8, 4096, 8192, 8193, 100_003):
            dp.reset_launches()
            same_bits(dp.pid_hist(k, P), dp.pid_hist(k.to(dev), P), f"P={P}")
            same_bits(dp.partition_index(k, P), dp.partition_index(k.to(dev), P))
            same_bits(dp.partition_ids(k, P), dp.partition_ids(k.to(dev), P))
            assert dp.launches["pid_hist"] == 3, P


def test_empty_inputs_launch_nothing(dev):
    dp.reset_launches()
    e32 = torch.empty(0, dtype=torch.float32, device=dev)
    e64 = torch.empty(0, dtype=torch.int64, device=dev)
    assert dp.filter_mask(e32, 0.0).shape == (0,)
    assert dp.map_derived(e32, e32).shape == (0,)
    assert dp.fixed_point_encode(e32, e64).shape == (0,)
    hit, pos = dp.probe_sorted(e64, torch.arange(3, device=dev))
    assert not hit.any() and (pos == 0).all() and hit.is_cuda
    assert dp.hash64(e64).shape == (0,)
    assert dp.partition_ids(e64, 8).shape == (0,)
    order, counts = dp.partition_index(e64, 8)
    assert order.shape == (0,) and counts.tolist() == [0] * 8 and counts.is_cuda
    assert all(v == 0 for v in dp.launches.values())


def test_wrappers_raise_instead_of_falling_back(dev):
    col = torch.zeros(8, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        dp.filter_mask(col[::2], 0.0)
    with pytest.raises(TypeError):
        dp.filter_mask(col.to(torch.int32), 0.0)
    with pytest.raises(ValueError, match="1-D"):
        dp.map_derived(col.reshape(2, 4), None)
    with pytest.raises(ValueError, match="lengths"):
        dp.map_derived(col, col[:4])
    with pytest.raises(TypeError):
        dp.probe_sorted(col, col)
    with pytest.raises(ValueError, match="device"):
        dp.map_derived(col, col.cpu())
    keys = torch.arange(16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        dp.hash64(keys[::2])
    with pytest.raises(ValueError, match="contiguous"):
        dp.partition_ids(keys[::2], 8)
    with pytest.raises(ValueError, match="2\\^31"):
        dp.partition_index(keys, 1 << 31)


def test_small_round_card_equals_cpu(dev, tmp_path):
    stores = {}
    for device in ("cuda", "cpu"):
        wl = mv.realize_workload(mv.generate_workload(12, seed=4),
                                 bytes_per_root=1 << 16, device=device)
        wl = mv.calibrate_sizes(wl, mv.DiskStore(tmp_path / f"c_{device}",
                                                 device=device))
        graph = wl.to_graph()
        budget = sum(graph.sizes) * 0.4
        store = mv.DiskStore(tmp_path / device, device=device)
        rep = mv.Controller(wl, store, budget).run(core.solve(graph, budget))
        assert rep.peak_catalog_bytes <= budget
        stores[device] = (wl, store)
    wl, card = stores["cuda"]
    for node in wl.nodes:
        got = card.read(node.name)
        assert all(v.is_cuda for v in got.values())
        T.assert_tables_bitwise(stores["cpu"][1].read(node.name), got, node.name)


def test_small_partitioned_scenario_card_equals_cpu(dev, tmp_path):
    spec = dict(mode="incremental", ingest_frac=0.1, update_frac=0.05,
                delete_frac=0.02, n_rounds=2)
    runs = {}
    for device in ("cuda", "cpu"):
        wl = mv.realize_workload(mv.generate_workload(12, seed=4),
                                 bytes_per_root=1 << 16, device=device)
        budget = sum(n.size for n in wl.nodes) * 0.4
        store = mv.DiskStore(tmp_path / device, device=device)
        dp.reset_launches()
        rep = mv.run_partitioned_scenario(wl, 8, store, budget,
                                          mv.UpdateSpec(**spec),
                                          core.PAPER_COST_MODEL)
        runs[device] = (wl, store, rep, dict(dp.launches),
                        dict(dp.variant_launches))
    wl, card, rep, launches, variants = runs["cuda"]
    assert launches["pid_hist"] > 0
    assert variants["fixed_point_encode/weighted"] > 0
    for a, b in zip(runs["cpu"][2].rounds, rep.rounds):
        assert (a.plan.order, a.plan.flagged, a.statuses, a.run.skipped) == \
            (b.plan.order, b.plan.flagged, b.statuses, b.run.skipped)
    assert all(v == 0 for v in runs["cpu"][3].values())
    assert card.manifest() == runs["cpu"][1].manifest()
    for name in card.manifest():
        T.assert_tables_bitwise(runs["cpu"][1].read(name), card.read(name), name)


def test_infer_schemas_on_the_card_launches_nothing_and_equals_cpu(dev):
    """Schema inference runs every operator on zero-row tensors on the
    card: the wrappers return before launching, and the schemas are the
    CPU's."""
    workloads = [mv.generate_workload(12, seed=4), mv.shared_prefix_workload(n_views=4)]
    for wl in workloads:
        ir = mvir.lift_workload(wl)
        dp.reset_launches()
        on_card = mvir.infer_schemas(ir, device=dev)
        assert all(v == 0 for v in dp.launches.values()), dp.launches
        assert all(v == 0 for v in dp.variant_launches.values())
        on_cpu = mvir.infer_schemas(ir, device="cpu")
        assert [n.schema for n in on_card.nodes] == [n.schema for n in on_cpu.nodes]
        assert all(n.schema is not None for n in on_card.nodes)


def test_small_merged_scenario_card_equals_cpu(dev, tmp_path):
    """The shared-prefix workload at 1 MiB per root, merged on each device:
    the same fingerprints and classes, each shared class once a round, and
    the merged stores bitwise equal card against CPU."""
    spec = dict(mode="incremental", ingest_frac=0.1, update_frac=0.05,
                delete_frac=0.02, n_rounds=2)
    runs = {}
    for device in ("cuda", "cpu"):
        wl = mv.realize_workload(mv.shared_prefix_workload(n_views=3),
                                 bytes_per_root=1 << 20, device=device)
        wl = mv.calibrate_sizes(wl, mv.DiskStore(tmp_path / f"c_{device}", device=device))
        merged = mv.merge_workload(wl, device=device)
        budget = sum(n.size for n in merged.workload.nodes) * 0.4
        store = mv.DiskStore(tmp_path / device, device=device)
        dp.reset_launches()
        rep = mv.run_scenario(merged.workload, store, budget, mv.UpdateSpec(**spec),
                              core.PAPER_COST_MODEL)
        runs[device] = (merged, store, rep, dict(dp.launches))
    merged, card, rep, launches = runs["cuda"]
    cpu_merged, cpu_store, _, cpu_launches = runs["cpu"]
    assert merged.fingerprints == cpu_merged.fingerprints
    assert merged.classes == cpu_merged.classes
    assert merged.shared == ("v0_filter", "v0_join")
    for r in rep.rounds:
        assert all(r.run.executed.count(name) == 1 for name in merged.shared)
    assert all(launches[k] > 0 for k in ("filter_gt", "map_derived",
                                         "fixed_point_encode", "probe_sorted"))
    assert all(v == 0 for v in cpu_launches.values())
    assert card.manifest() == cpu_store.manifest()
    for name in card.manifest():
        T.assert_tables_bitwise(cpu_store.read(name), card.read(name), name)


# ---------------------------------------------------------------------------
# model kernels
# ---------------------------------------------------------------------------

RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def randn(shape, dtype, seed, scale=1.0, shift=0.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale + shift
    return torch.from_numpy(a.astype(np.float32)).to(dtype)


def close(cpu_out, cuda_out, tol, ctx=""):
    for a, b in zip(cpu_out, cuda_out):
        b = b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, ctx
        torch.testing.assert_close(b.float(), a.float(), atol=tol, rtol=tol,
                                   msg=lambda m: f"{ctx}\n{m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2048, 5120), (4, 5120), (3, 5, 128), (7, 100),
                                   (1, 10000)])
def test_rmsnorm_kernel_matches_cpu(dev, shape, dtype):
    x = randn(shape, dtype, 1)
    r = randn(shape, dtype, 2)
    for w in (randn(shape[-1:], dtype, 3, 0.1, 1.0),
              randn(shape[-1:], torch.float32, 3, 0.1, 1.0)):
        for res in (None, r):
            ops.reset_launches()
            got = ops.rmsnorm(x.to(dev), w.to(dev), residual=None if res is None
                              else res.to(dev))
            assert ops.launches["rmsnorm"] == 1
            assert ops.variant_launches["rmsnorm/residual"] == (res is not None)
            # rows of a multiple of 8 on 16 bytes take the vector kernel
            assert ops.variant_launches["rmsnorm/scalar"] == (shape[-1] % 8 != 0)
            close((kref.rmsnorm(x, w, residual=res),), (got,), RMS_TOL[dtype],
                  f"{shape} w {w.dtype} residual {res is not None}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_scalar_kernel_on_rows_off_16_bytes(dev, dtype):
    """Rows that do not start on 16 bytes take the scalar kernel, with and
    without a residual, and agree with the CPU as the vector kernel does."""
    shape = (64, 5120)
    x, r = randn(shape, dtype, 1), randn(shape, dtype, 2)
    w = randn(shape[-1:], dtype, 3, 0.1, 1.0)
    n = x.numel()
    xd = torch.empty(n + 1, dtype=dtype, device=dev)[1:].view(shape)
    xd.copy_(x.to(dev))
    for res in (None, r):
        ops.reset_launches()
        got = ops.rmsnorm(xd, w.to(dev), residual=None if res is None else res.to(dev))
        assert ops.launches["rmsnorm"] == ops.variant_launches["rmsnorm/scalar"] == 1
        close((kref.rmsnorm(x, w, residual=res),), (got,), RMS_TOL[dtype], f"residual {res is not None}")


BWD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
FLASH_CASES = [  # b, hq, hkv, sq, sk, d, causal
    (4, 32, 8, 544, 544, 160, True),    # the serving oracle
    (1, 32, 32, 1000, 1000, 80, True),  # stablelm-3b's MHA, head dim 80
    (2, 32, 8, 40, 72, 160, False),     # ragged
    (2, 32, 8, 100, 300, 160, True),    # causal, sq < sk
    (1, 8, 2, 300, 100, 160, True),     # causal, sq > sk
    (2, 8, 2, 65, 65, 16, True),        # reduced models' head dim
    (1, 16, 16, 130, 130, 256, True),   # gemma-7b's head dim
    (1, 4, 1, 1, 257, 128, False),      # one query (decode shape)
    (1, 6, 3, 33, 47, 100, False),      # a head dim between the padded widths; rows
                                        # off 16 bytes (element loads in bf16)
    # the tensor-core kernels' tile boundaries (64 rows) at training's head dim
    (1, 8, 2, 63, 63, 80, True),
    (1, 8, 2, 64, 64, 80, True),
    (1, 8, 2, 65, 65, 80, True),
    (1, 8, 2, 129, 129, 80, True),
    (1, 8, 2, 191, 191, 80, True),
    (1, 8, 2, 200, 70, 80, True),       # causal, sq > sk, at d 80
    (1, 8, 2, 150, 150, 64, True),      # the other widths dk/dv's mma kernel holds
    (1, 8, 2, 150, 150, 96, True),
    (1, 8, 2, 150, 150, 128, True),
]
# The kernel each bf16 flash launch must take (f32 always keeps the CUDA
# cores): the tensor cores up to these head widths.
MMA_WIDTH = {"flash_fwd": 256, "flash_bwd_dq": 256, "flash_bwd_dkv": 256}


def expect_variant(kernel, dtype, d):
    """Raise unless the one launch of ``kernel`` was counted under the
    variant its dtype and head width call for."""
    want = "mma" if dtype == torch.bfloat16 and d <= MMA_WIDTH[kernel] else "cuda_core"
    got = {name: n for name, n in ops.variant_launches.items() if name.startswith(kernel)}
    assert got == {f"{kernel}/{name}": int(name == want) for name in ("mma", "cuda_core")}, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", FLASH_CASES)
def test_flash_fwd_kernel_matches_cpu(dev, b, hq, hkv, sq, sk, d, causal, dtype):
    q = randn((b, hq, sq, d), dtype, 1)
    k = randn((b, hkv, sk, d), dtype, 2)
    v = randn((b, hkv, sk, d), dtype, 3)
    ops.reset_launches()
    got = flash_attention_fwd(q.to(dev), k.to(dev), v.to(dev), causal=causal)
    assert ops.launches["flash_fwd"] == 1
    expect_variant("flash_fwd", dtype, d)
    close(flash_attention_fwd(q, k, v, causal=causal), got, ATTN_TOL[dtype])
    assert torch.isfinite(got[1]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fwd_repeats_bitwise(dev, dtype):
    """The forward is deterministic: 20 runs at the serving oracle's shape
    (where one f32 run once differed from the CPU) give the same bits, and
    lie within ATTN_TOL of the CPU. Names the first run that differs."""
    b, hq, hkv, sq, sk, d, causal = FLASH_CASES[0]
    q = randn((b, hq, sq, d), dtype, 1)
    k = randn((b, hkv, sk, d), dtype, 2)
    v = randn((b, hkv, sk, d), dtype, 3)
    args = [t.to(dev) for t in (q, k, v)]
    first = flash_attention_fwd(*args, causal=causal)
    close(flash_attention_fwd(q, k, v, causal=causal), first, ATTN_TOL[dtype])
    differs = []
    for run in range(1, 20):
        o, lse = flash_attention_fwd(*args, causal=causal)
        if not (torch.equal(o, first[0]) and torch.equal(lse, first[1])):
            differs.append(run)
    assert not differs, f"runs {differs} differ from run 0 (first: {differs[:1]})"


def rel_close(cpu_out, cuda_out, rel, ctx=""):
    """||cuda - cpu|| / ||cpu|| <= rel for each output, over the entries the
    CPU gives finite (a keyless row's +inf lse is held by ``close``)."""
    for a, b in zip(cpu_out, cuda_out):
        fin = torch.isfinite(a)
        want = a[fin].double()
        diff = float((b.cpu()[fin].double() - want).norm())
        assert diff <= rel * float(want.norm()), f"{ctx}: {diff} > {rel} x {float(want.norm())}"


@pytest.mark.parametrize("s", [63, 64, 65, 129])
@pytest.mark.parametrize("d", [80, 100, 160, 256])
def test_flash_fwd_f32_tile_edges(dev, d, s):
    """The f32 forward's tiles (128 query rows up to head dim 96, 64 above;
    64 kv rows) at their edges, causal with GQA and non-causal, at head dims
    on and between its padded widths: within 2e-5 and 1e-4 of ||want||."""
    for causal in (True, False):
        q = randn((1, 8, s, d), torch.float32, 11)
        k = randn((1, 2, s, d), torch.float32, 12)
        v = randn((1, 2, s, d), torch.float32, 13)
        ops.reset_launches()
        got = flash_attention_fwd(q.to(dev), k.to(dev), v.to(dev), causal=causal)
        expect_variant("flash_fwd", torch.float32, d)
        want = flash_attention_fwd(q, k, v, causal=causal)
        close(want, got, ATTN_TOL[torch.float32], f"d {d} s {s} causal {causal}")
        rel_close(want, got, 1e-4, f"d {d} s {s} causal {causal}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", FLASH_CASES)
def test_flash_bwd_kernels_match_cpu(dev, b, hq, hkv, sq, sk, d, causal, dtype):
    """Both backward kernels against the plain backward on the CPU, from
    the CPU forward's o and lse (so both sides see the same inputs)."""
    q = randn((b, hq, sq, d), dtype, 1)
    k = randn((b, hkv, sk, d), dtype, 2)
    v = randn((b, hkv, sk, d), dtype, 3)
    do = randn((b, hq, sq, d), dtype, 4)
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    ops.reset_launches()
    got = flash_attention_bwd(*(t.to(dev) for t in (q, k, v, o, lse, do)), causal=causal)
    assert ops.launches["flash_bwd_dq"] == 1 and ops.launches["flash_bwd_dkv"] == 1
    expect_variant("flash_bwd_dq", dtype, d)
    expect_variant("flash_bwd_dkv", dtype, d)
    close(flash_attention_bwd(q, k, v, o, lse, do, causal=causal), got, BWD_TOL[dtype],
          f"{(b, hq, hkv, sq, sk, d, causal)} {dtype}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[1]])
def test_flash_bwd_dq_repeats_bitwise(dev, case, dtype):
    """Each dq kernel (bf16 on the tensor cores, f32 on the CUDA cores) is
    deterministic: 20 launches at the serving oracle's shape and at the
    training head dim 80 give the same bits, all counted under the dtype's
    variant, and lie within BWD_TOL of the CPU. Names the first launch that
    differs."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, d, causal = case
    q, k, v, do = (randn(shape, dtype, seed) for seed, shape in enumerate(
        ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d)), 1))
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    want = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)[0]
    args = [t.to(dev) for t in (q, k, v, do, lse)]
    delta = (args[3].float() * o.to(dev).float()).sum(-1)
    ops.reset_launches()
    first = fa._launch_dq(*args, delta, causal, 1.0 / d**0.5)
    close((want,), (first,), BWD_TOL[dtype], f"{case}")
    differs = [run for run in range(1, 20) if not torch.equal(
        fa._launch_dq(*args, delta, causal, 1.0 / d**0.5), first)]
    kind = "mma" if dtype == torch.bfloat16 else "cuda_core"
    assert ops.variant_launches[f"flash_bwd_dq/{kind}"] == ops.launches["flash_bwd_dq"] == 20
    assert not differs, f"runs {differs} differ from run 0 (first: {differs[:1]})"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_dkv_repeats_bitwise(dev, dtype):
    """Each dk/dv kernel at the serving oracle's head dim 160 (both split
    across warps that exchange Pᵀ in shared memory: bf16 two warps per 16
    kv rows, f32 two halves of the block) is deterministic: 20 launches give
    the same bits, each within BWD_TOL of the CPU, all counted under the
    dtype's variant. Names the first launch that differs."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, sq, sk, d, causal = FLASH_CASES[0]
    q, k, v, do = (randn(shape, dtype, seed) for seed, shape in enumerate(
        ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d)), 1))
    o, lse = flash_attention_fwd(q, k, v, causal=causal)
    want = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)[1:]
    args = [t.to(dev) for t in (q, k, v, do, lse)]
    delta = (args[3].float() * o.to(dev).float()).sum(-1)
    ops.reset_launches()
    first = fa._launch_dkv(*args, delta, causal, 1.0 / d**0.5)
    close(want, first, BWD_TOL[dtype], "dk, dv")
    differs = [run for run in range(1, 20) if not all(
        torch.equal(a, b) for a, b in zip(fa._launch_dkv(*args, delta, causal, 1.0 / d**0.5),
                                          first))]
    kind = "mma" if dtype == torch.bfloat16 else "cuda_core"
    assert ops.variant_launches[f"flash_bwd_dkv/{kind}"] == ops.launches["flash_bwd_dkv"] == 20
    assert not differs, f"runs {differs} differ from run 0 (first: {differs[:1]})"


@pytest.mark.parametrize("s", [63, 64, 65, 129])
@pytest.mark.parametrize("d", [80, 100, 160, 256])
def test_flash_bwd_f32_tile_edges(dev, d, s):
    """The f32 backward's tiles (dq: 128 query rows up to head dim 112, 64
    above; dk/dv: 64 kv rows, 32 at 256; 64-row tiles of the other side) at
    their edges, causal with GQA and non-causal, at head dims on and
    between its padded widths, with ``do`` a transposed view (as autograd
    hands it back): dq, dk and dv within 2e-4 and 1e-4 of ||want||."""
    for causal in (True, False):
        q = randn((1, 8, s, d), torch.float32, 11)
        k = randn((1, 2, s, d), torch.float32, 12)
        v = randn((1, 2, s, d), torch.float32, 13)
        do = randn((1, s, 8, d), torch.float32, 14).transpose(1, 2)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        ops.reset_launches()
        got = flash_attention_bwd(*(t.to(dev) for t in (q, k, v, o, lse, do)), causal=causal)
        expect_variant("flash_bwd_dq", torch.float32, d)
        expect_variant("flash_bwd_dkv", torch.float32, d)
        want = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        close(want, got, BWD_TOL[torch.float32], f"d {d} s {s} causal {causal}")
        rel_close(want, got, 1e-4, f"d {d} s {s} causal {causal}")


@pytest.mark.parametrize("d", [160, 256])
def test_flash_bwd_wide_heads_keyless_rows_and_strided_grad(dev, d):
    """bf16 at the wide heads on the tensor cores: a causal query block past
    every key (sq > sk, rows above the first key column's reach add nothing),
    a key set of length 0 (dq = 0, empty dk and dv), and the transposed
    output gradient autograd hands the Function, against the CPU."""
    dtype = torch.bfloat16
    q = torch.ones(1, 4, 8, d, dtype=dtype, device=dev)
    empty = torch.ones(1, 2, 0, d, dtype=dtype, device=dev)
    o, lse = flash_attention_fwd(q, empty, empty)
    dq, dk, dv = flash_attention_bwd(q, empty, empty, o, lse, torch.ones_like(q))
    assert not dq.any() and dk.shape == (1, 2, 0, d) and dv.shape == dk.shape
    qs = randn((2, 70, 16, d), dtype, 5)     # (b, s, h, d), causal sq > sk
    kv = randn((2, 40, 4, d), dtype, 6)
    g = randn((2, 70, 16, d), dtype, 7)
    grads = []
    for device in ("cpu", dev):
        ops.reset_launches()
        leaves = [t.detach().to(device).requires_grad_(True) for t in (qs, kv, kv.clone())]
        out = ops.flash_attention(*(t.transpose(1, 2) for t in leaves))
        out.transpose(1, 2).backward(g.to(device))
        grads.append(tuple(t.grad for t in leaves))
    assert ops.variant_launches["flash_bwd_dkv/mma"] == 1
    close(grads[0], grads[1], BWD_TOL[dtype], f"d {d}")


def test_flash_bwd_dq_entries_refuse_what_they_do_not_run(dev):
    """Neither dq kernel takes the other's inputs: the CUDA-core entry
    refuses bf16, the tensor-core entry head widths past 256; each refusal
    raises and counts no launch."""
    import ctypes

    from repro_torch import native
    from repro_torch.kernels import flash_attention as fa

    def launch(entry, dtype, d, last):
        q = torch.ones(1, 2, 8, d, dtype=dtype, device=dev)
        lse = torch.zeros(1, 2, 8, device=dev)
        args = (q, q[:, :1], q[:, :1], q, lse, lse, torch.empty_like(q))
        native.launch("flash_bwd_dq", entry, dev, *(native.ptr(t) for t in args),
                      *(ctypes.c_int(n) for n in (1, 2, 1, 8, 8, d)),
                      ctypes.cast(fa._strides(*args[:4]), ctypes.c_void_p),
                      ctypes.c_float(1.0), ctypes.c_int(1), ctypes.c_int(last))

    ops.reset_launches()
    with pytest.raises(RuntimeError, match="sc_flash_bwd_dq"):
        launch("sc_flash_bwd_dq", torch.bfloat16, 80, 1)       # dtype code 1: bf16
    with pytest.raises(RuntimeError, match="sc_flash_bwd_dq_mma"):
        launch("sc_flash_bwd_dq_mma", torch.bfloat16, 320, 1)  # aligned, d > 256
    assert ops.launches["flash_bwd_dq"] == 0


@pytest.mark.parametrize("d", [80, 160, 256])
def test_flash_cuda_core_entries_refuse_bf16(dev, d):
    """The CUDA-core forward and dk/dv entries take f32 only: a bf16 launch
    (dtype code 1) raises and counts no launch, at every head width (bf16
    dk/dv above 128 runs on the tensor cores)."""
    import ctypes

    from repro_torch import native
    from repro_torch.kernels import flash_attention as fa

    q = torch.ones(1, 2, 8, d, dtype=torch.bfloat16, device=dev)
    lse = torch.zeros(1, 2, 8, device=dev)
    shape = [ctypes.c_int(n) for n in (1, 2, 1, 8, 8, d)]
    tail = (ctypes.c_float(1.0), ctypes.c_int(1), ctypes.c_int(1))
    ops.reset_launches()
    with pytest.raises(RuntimeError, match="sc_flash_fwd"):
        native.launch("flash_fwd", "sc_flash_fwd", dev,
                      *(native.ptr(t) for t in (q, q[:, :1], q[:, :1], torch.empty_like(q), lse)),
                      *shape, ctypes.cast(fa._strides(q, q[:, :1], q[:, :1]), ctypes.c_void_p),
                      *tail)
    with pytest.raises(RuntimeError, match="sc_flash_bwd_dkv"):
        kv = torch.empty_like(q[:, :1])
        native.launch("flash_bwd_dkv", "sc_flash_bwd_dkv", dev,
                      *(native.ptr(t) for t in (q, q[:, :1], q[:, :1], q, lse, lse, kv, kv)),
                      *shape, ctypes.cast(fa._strides(q, q[:, :1], q[:, :1], q), ctypes.c_void_p),
                      *tail)
    assert ops.launches["flash_fwd"] == ops.launches["flash_bwd_dkv"] == 0


def test_flash_bwd_keyless_rows_and_strided_grad(dev):
    """A key set of length 0 gives dq = 0 and empty dk/dv; a causal query
    above every key (sq > sk) adds nothing to dk/dv past its row; the
    transposed output gradient autograd hands the Function reaches the
    kernel as a view."""
    q = torch.ones(1, 4, 8, 64, device=dev)
    empty = torch.ones(1, 2, 0, 64, device=dev)
    o, lse = flash_attention_fwd(q, empty, empty)
    dq, dk, dv = flash_attention_bwd(q, empty, empty, o, lse, torch.ones_like(q))
    assert not dq.any() and dk.shape == (1, 2, 0, 64) and dv.shape == dk.shape
    qs = randn((2, 24, 32, 80), torch.float32, 5)      # (b, s, h, d)
    kv = randn((2, 24, 8, 80), torch.float32, 6)
    g = randn((2, 24, 32, 80), torch.float32, 7)
    grads = []
    for device in ("cpu", dev):
        leaves = [t.detach().to(device).requires_grad_(True) for t in (qs, kv, kv.clone())]
        out = ops.flash_attention(*(t.transpose(1, 2) for t in leaves))
        out.transpose(1, 2).backward(g.to(device))
        grads.append(tuple(t.grad for t in leaves))
    close(grads[0], grads[1], BWD_TOL[torch.float32])


def test_flash_fwd_kernel_takes_strided_views_and_empty_keys(dev):
    """The model's transposed q/k/v views, and a key set of length 0 (every
    row masked: o = 0, lse = +inf)."""
    q = randn((2, 24, 32, 160), torch.bfloat16, 4)    # (b, s, h, d)
    kv = randn((2, 24, 8, 160), torch.bfloat16, 5)
    want = flash_attention_fwd(*(t.transpose(1, 2) for t in (q, kv, kv)))
    got = flash_attention_fwd(*(t.to(dev).transpose(1, 2) for t in (q, kv, kv)))
    close(want, got, ATTN_TOL[torch.bfloat16])
    o, lse = flash_attention_fwd(torch.ones(1, 4, 8, 64, device=dev),
                                 *[torch.ones(1, 2, 0, 64, device=dev)] * 2)
    assert not o.any() and torch.isposinf(lse).all()


def test_model_kernel_wrappers_raise_instead_of_falling_back(dev):
    x = torch.ones(4, 64, device=dev)
    with pytest.raises(ValueError, match="device"):
        ops.rmsnorm(x, torch.ones(64))
    with pytest.raises(TypeError):
        ops.rmsnorm(x.half(), torch.ones(64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm(x.t(), torch.ones(4, device=dev))
    q = torch.ones(1, 4, 8, 64, device=dev)
    with pytest.raises(ValueError, match="device"):
        ops.flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q.bfloat16())
    big = torch.ones(1, 1, 4, 320, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(big, big, big)


def test_small_model_serving_card_equals_cpu(dev):
    cfg = configs.get_config("stablelm-12b").reduced(dtype="float32", n_heads=8,
                                                     n_kv_heads=2)
    cpu_model = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_model = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(dev)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)))
    ops.reset_launches()
    got = serve.greedy_generate(cfg, card_model, prompt, 6)
    assert ops.launches == {"rmsnorm": (2 * cfg.n_layers + 1) * 6, "flash_fwd": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "ssd_scan": 0}
    assert torch.equal(got.cpu(), serve.greedy_generate(cfg, cpu_model, prompt, 6, "cpu"))
    ops.reset_launches()
    card_logits, _, _ = models.forward(cfg, card_model, prompt.to(dev))
    assert ops.launches["flash_fwd"] == cfg.n_layers
    cpu_logits, _, _ = models.forward(cfg, cpu_model, prompt)
    torch.testing.assert_close(card_logits.cpu(), cpu_logits, atol=1e-4, rtol=1e-4)


def test_small_train_steps_card_equal_cpu(dev):
    """Two train steps of 2 microbatches of reduced stablelm-3b with GQA in
    f32, weights made once on the CPU: loss and grad norm within 1e-5
    relative (``tests/test_torch_train.py``'s tolerance); parameters within
    lr/4, and at most 1e-3 of them beyond 1e-5 (Adam's normalised update
    turns the last bits of a gradient near eps into a different fraction
    of a step), so the first microbatch's gradients before any update are
    held directly within 1e-5 + 1e-4·|g|; every model kernel launches on
    the card, none on the CPU."""
    import copy

    from repro_torch.train import AdamWConfig, init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config("stablelm-3b").reduced(dtype="float32", n_heads=8, n_kv_heads=2)
    cpu_model = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    states = {"cpu": init_train_state(cfg, cpu_model),
              "card": init_train_state(cfg, copy.deepcopy(cpu_model).to(dev))}
    rng = np.random.default_rng(2)
    seqs = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 33)).astype(np.int32))
            for _ in range(2)]
    places = {"cpu": torch.device("cpu"), "card": dev}

    def first_grads(where):
        model = states[where]["params"]
        loss, _ = models.lm_loss(cfg, model, {"tokens": seqs[0][:2, :-1].to(places[where]),
                                              "labels": seqs[0][:2, 1:].to(places[where])})
        return [g.cpu() for g in torch.autograd.grad(loss, list(model.parameters()))]

    for g_card, g_cpu in zip(first_grads("card"), first_grads("cpu"), strict=True):
        torch.testing.assert_close(g_card, g_cpu, atol=1e-5, rtol=1e-4)
    out = {}
    for where, device in places.items():
        step = make_train_step(cfg, AdamWConfig(lr=1e-2, warmup_steps=2), global_rows=4)
        ops.reset_launches()
        mets = []
        for s in seqs:
            states[where], m = step(states[where], {"tokens": s[:, :-1].to(device),
                                                   "labels": s[:, 1:].to(device)})
            mets.append(m)
        out[where] = (mets, dict(ops.launches))
    assert not any(out["cpu"][1].values())
    n = 2 * 2  # steps x microbatches
    assert out["card"][1] == {"rmsnorm": n * (4 * cfg.n_layers + 1),
                              "flash_fwd": n * 2 * cfg.n_layers,
                              "flash_bwd_dq": n * cfg.n_layers,
                              "flash_bwd_dkv": n * cfg.n_layers, "ssd_scan": 0}
    for mc, mg in zip(out["cpu"][0], out["card"][0]):
        for key in ("loss", "grad_norm"):
            torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=1e-5, atol=0)
    cpu_p = dict(states["cpu"]["params"].named_parameters())
    diff = torch.cat([(p.detach().cpu() - cpu_p[n].detach()).abs().reshape(-1)
                      for n, p in states["card"]["params"].named_parameters()])
    assert float(diff.max()) <= 1e-2 / 4
    assert float((diff > 1e-5).float().mean()) <= 1e-3


SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
SSD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # of ||want||
SSD_CASES = [  # b, s, h, p, n, chunk
    (2, 20, 8, 16, 16, 64),     # the reduced configs: chunk = s = 20
    (1, 64, 2, 16, 8, 16),
    (2, 128, 1, 32, 16, 32),
    (1, 96, 3, 8, 8, 32),
    (1, 72, 2, 40, 100, 24),    # widths that are not powers of two
    (4, 512, 80, 64, 128, 64),  # mamba2-2.7b's serving prefill
    (1, 4096, 80, 64, 128, 64),  # 64 chunks of one row
]


def ssd_inputs(b, s, h, p, n, dtype, seed=7):
    """x, dt, a (f32), and B and C as the two halves of one (b, s, 2n)
    tensor, as the model hands them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p))
    dt = np.logaddexp(rng.standard_normal((b, s, h)), 0.0) * 0.1
    a = -np.exp(rng.standard_normal(h) * 0.5)
    bc = rng.standard_normal((b, s, 2 * n)) / np.sqrt(n)
    x, dt, bc = (torch.from_numpy(t.astype(np.float32)).to(dtype) for t in (x, dt, bc))
    return x, dt, torch.from_numpy(a.astype(np.float32)), bc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_scan_kernel_matches_cpu(dev, b, s, h, p, n, chunk, dtype):
    """y within the JAX tests' tolerance of the CPU path, and the state
    after the last chunk (f32) within 1e-4 of ||want||; one launch a call."""
    x, dt, a, bc = ssd_inputs(b, s, h, p, n, dtype)
    ops.reset_launches()
    xd, dtd, ad, bcd = (t.to(dev) for t in (x, dt, a, bc))
    got, got_state = ssd_scan(xd, dtd, ad, bcd[..., :n], bcd[..., n:], chunk=chunk,
                              return_state=True)
    assert ops.launches["ssd_scan"] == 1
    want, want_state = ssd_scan(x, dt, a, bc[..., :n], bc[..., n:], chunk=chunk,
                                return_state=True)
    close((want,), (got,), SSD_TOL[dtype], f"{(b, s, h, p, n, chunk)} {dtype}")
    g, w = got.cpu().float(), want.float()
    rel, rms = float((g - w).norm() / w.norm()), float(w.square().mean().sqrt())
    assert rel <= SSD_REL_TOL[dtype], f"||got - want|| / ||want|| = {rel}, RMS |want| {rms}"
    assert got_state.dtype == torch.float32 and got_state.shape == (b, h, p, n)
    state_rel = float((got_state.cpu() - want_state).norm() / want_state.norm())
    assert state_rel <= SSD_REL_TOL[torch.float32], state_rel
    if s <= 128 and dtype == torch.float32:   # and the exact recurrence
        close((kref.ssd_scan_sequential(x, dt, a, bc[..., :n], bc[..., n:]),), (got,),
              SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("limit_chunks,plan", [(1, (1, 1)), (3, (1, 3)), (10, (2, 5))])
def test_ssd_scan_workspace_groups_and_segments(dev, monkeypatch, limit_chunks, plan, dtype):
    """With the workspace cut to ``limit_chunks`` chunks, the one C entry
    runs the batch rows in groups and a row's chunks in segments, carrying
    the state between segments: the same y and final state as the CPU path,
    one launch."""
    from repro_torch.kernels import ssd_scan as mod

    b, s, h, p, n, chunk = 3, 320, 4, 16, 32, 64
    bf16 = dtype == torch.bfloat16
    x, dt, a, bc = ssd_inputs(b, s, h, p, n, dtype)
    monkeypatch.setattr(mod, "WORKSPACE_BYTES",
                        limit_chunks * 4 * mod.workspace_floats(h, p, n, chunk, bf16) + 64)
    assert mod.workspace_plan(b, s, h, p, n, chunk, bf16) == plan
    ops.reset_launches()
    got, got_state = ssd_scan(*(t.to(dev) for t in (x, dt, a)), bc[..., :n].to(dev),
                              bc[..., n:].to(dev), chunk=chunk, return_state=True)
    assert ops.launches["ssd_scan"] == 1
    want, want_state = ssd_scan(x, dt, a, bc[..., :n], bc[..., n:], chunk=chunk,
                                return_state=True)
    close((want,), (got,), SSD_TOL[dtype])
    state_rel = float((got_state.cpu() - want_state).norm() / want_state.norm())
    assert state_rel <= SSD_REL_TOL[torch.float32], state_rel


def test_ssd_scan_carries_an_impulse_across_chunks(dev):
    x = torch.zeros(1, 64, 1, 4, device=dev)
    x[0, 0] = 1.0
    dt = torch.full((1, 64, 1), 0.05, device=dev)
    a = torch.tensor([-0.1], device=dev)
    ones = torch.ones(1, 64, 4, device=dev)
    y = ssd_scan(x, dt, a, ones, ones, chunk=16)
    assert float(y[0, -1].abs().sum()) > 0
    close((kref.ssd_scan_sequential(*(t.cpu() for t in (x, dt, a, ones, ones))),), (y,),
          1e-5)


def test_ssd_scan_wrapper_raises_instead_of_falling_back(dev):
    x, dt, a, bc = (t.to(dev) for t in ssd_inputs(1, 128, 2, 16, 8, torch.float32))
    bm, cm = bc[..., :8], bc[..., 8:]
    with pytest.raises(ValueError, match="device"):
        ssd_scan(x, dt, a.cpu(), bm, cm)
    with pytest.raises(ValueError, match="beyond"):
        ssd_scan(x, dt, a, bm, cm, chunk=128)
    wide = torch.ones(1, 64, 2, 65, device=dev)
    with pytest.raises(ValueError, match="beyond"):
        ssd_scan(wide, dt[:, :64], a, bm[:, :64], cm[:, :64])
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x, dt, a, bc[..., ::2], cm)
    with pytest.raises(TypeError):
        ssd_scan(x.half(), dt.half(), a, bm.half(), cm.half())
    with pytest.raises(ValueError, match="device"):   # under grad too
        ssd_scan(x.requires_grad_(True), dt, a.cpu(), bm, cm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_gradients_match_cpu(dev, dtype):
    """Under grad the scan is the autograd Function: one forward launch,
    none in the backward (PyTorch ops); the five gradients, B and C through
    the halves of one tensor, within the scan's tolerances of the CPU's
    (the plain forward and the same backward), and 1e-4 / 1e-2 of
    ||want||."""
    b, s, h, p, n, chunk = 2, 192, 4, 16, 32, 64
    x, dt, a, bc = ssd_inputs(b, s, h, p, n, dtype)
    dy = torch.from_numpy(np.random.default_rng(9).standard_normal((b, s, h, p))
                          .astype(np.float32)).to(dtype)
    grads = {}
    for where in ("cpu", dev):
        leaves = [t.to(where).requires_grad_(True) for t in (x, dt, a, bc)]
        ops.reset_launches()
        y = ssd_scan(*leaves[:3], leaves[3][..., :n], leaves[3][..., n:], chunk=chunk)
        grads[str(where)] = torch.autograd.grad(y, leaves, dy.to(where))
        assert ops.launches["ssd_scan"] == (0 if where == "cpu" else 1)
    for w, g in zip(grads["cpu"], grads[str(dev)]):
        assert g.dtype == w.dtype and g.shape == w.shape
        close((w,), (g,), SSD_TOL[dtype])
        rel = float((g.cpu().float() - w.float()).norm() / w.float().norm())
        assert rel <= SSD_REL_TOL[dtype], rel


def test_small_mamba_serving_card_equals_cpu(dev):
    """Reduced mamba2-2.7b in f32: the same greedy tokens card vs CPU, and
    forward logits within 1e-4; the scan launches once per layer and
    prefill, RMSNorm twice per layer and once at the final norm per
    forward, and no flash kernel."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config("mamba2-2.7b").reduced(dtype="float32")
    cpu_model = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card_model = models.init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(dev)
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 20)))
    ops.reset_launches()
    got = serve.greedy_generate(cfg, card_model, prompt, 6)
    assert ops.launches == {"rmsnorm": (2 * cfg.n_layers + 1) * 6, "flash_fwd": 0,
                            "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                            "ssd_scan": cfg.n_layers}
    assert torch.equal(got.cpu(), serve.greedy_generate(cfg, cpu_model, prompt, 6, "cpu"))
    card_logits, _, _ = models.forward(cfg, card_model, prompt.to(dev))
    cpu_logits, _, _ = models.forward(cfg, cpu_model, prompt)
    torch.testing.assert_close(card_logits.cpu(), cpu_logits, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# multi-host refresh: forked hosts on the card
# ---------------------------------------------------------------------------

# One multi-host scenario on the card, run in a fresh interpreter (this
# test process has initialised CUDA, and its forks could not use the card):
# the default device throughout (``DiskStore(root)``, ``realize_workload``
# without ``device``), the process backend, 2 hosts, P = 4; prints the
# report's hosts lost, re-dispatch sources, launches and the store's device.
MULTIHOST_CHILD = """
import json, sys
import torch
import repro_torch.core as pc
import repro_torch.mv as mv
root, fault = sys.argv[1], sys.argv[2]
wl = mv.realize_workload(mv.generate_workload(n_nodes=10, seed=7),
                         bytes_per_root=1 << 16, seed=7, key_skew=1.0)
store = mv.DiskStore(root)
fp = mv.FaultPlan((mv.FaultAction("kill", host=1, round_idx=1, after_tasks=1),)
                  if fault == "kill" else ())
assert not torch.cuda.is_initialized()
rep = mv.run_multihost_scenario(
    wl, 4, store, [float(1 << 21)] * 2,
    mv.UpdateSpec(mode="incremental", n_rounds=2, ingest_frac=0.2, update_frac=0.15),
    pc.CostModel(disk_read_bw=50e6, disk_write_bw=50e6, mem_read_bw=1e12,
                 mem_write_bw=1e12, disk_latency=0.0),
    backend="process", fault_plan=fp, round_timeout=300.0)
print(json.dumps(dict(hosts_lost=rep.hosts_lost, launches=rep.launches,
                      device=str(store.device),
                      redispatch_from=sorted({r.from_host for r in rep.redispatches}),
                      used=[hs.used_bytes for r in rep.rounds for hs in r.host_stats
                            if hs.alive])))
"""


@pytest.mark.parametrize("fault", ["none", "kill"])
def test_multihost_process_hosts_on_card_equal_cpu(dev, tmp_path, fault):
    """Two forked hosts compute on the card (the default device, asked
    without initialising CUDA before the fork), fault-free and with host 1
    killed mid-round; the store equals the CPU thread-backend run's
    bitwise, and every host ships non-zero launches of the round's
    data-plane kernels."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    res = subprocess.run([sys.executable, "-c", MULTIHOST_CHILD, str(tmp_path / "card"),
                          fault], env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["device"] == "cuda"
    assert out["hosts_lost"] == ([1] if fault == "kill" else [])
    assert out["redispatch_from"] == ([1] if fault == "kill" else [])
    assert not any(out["used"])
    for k in ("filter_gt", "map_derived", "fixed_point_encode", "probe_sorted",
              "pid_hist", "fixed_point_encode/weighted"):
        assert out["launches"][k] > 0, (k, out["launches"])
    wl = mv.realize_workload(mv.generate_workload(n_nodes=10, seed=7),
                             bytes_per_root=1 << 16, seed=7, key_skew=1.0, device="cpu")
    cpu = mv.DiskStore(tmp_path / "cpu", device="cpu")
    mv.run_multihost_scenario(
        wl, 4, cpu, [float(1 << 21)] * 2,
        mv.UpdateSpec(mode="incremental", n_rounds=2, ingest_frac=0.2, update_frac=0.15),
        core.CostModel(disk_read_bw=50e6, disk_write_bw=50e6, mem_read_bw=1e12,
                       mem_write_bw=1e12, disk_latency=0.0),
        backend="thread")
    card = mv.DiskStore(tmp_path / "card", device="cpu")
    assert card.manifest().keys() == cpu.manifest().keys()
    pwl, _ = mv.partition_workload(wl, 4)
    mv.verify_scenario_equivalence(pwl, cpu, card)


def test_multihost_process_pool_refuses_after_cuda_init(dev, tmp_path):
    torch.cuda.init()
    wl = mv.realize_workload(mv.generate_workload(n_nodes=10, seed=7),
                             bytes_per_root=1 << 16, seed=7, device=dev)
    pwl, pmap = mv.partition_workload(wl, 4)
    spec = mv.partition.expand_update_spec(
        mv.UpdateSpec(mode="incremental", n_rounds=1, ingest_frac=0.2), pmap)
    with pytest.raises(RuntimeError, match="initialised CUDA"):
        mv.HostPool(pwl, mv.DiskStore(tmp_path, device=dev), [float(1 << 21)] * 2,
                    spec, backend="process")
