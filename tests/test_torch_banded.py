"""The port's banded palette gather against the JAX package's: the host
planners give equal plans on the same ids, the plain K4/K5 agree exactly
with `banded_gather_xla(_multi)`, `build_uvt_tables` picks the same route
with equal tables, and the three palette routes render the same frames
and give the same one-step feature gradient as JAX's routes (within 1e-6:
gathers are exact, the sums over a batch and the overflow segment-sums
run in another order)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tclight_tpu.ops import banded_gather as jbg
from tclight_tpu.pipeline import postopt as jpo
from tclight_torch.ops import banded_gather as bg
from tclight_torch.ops import kernels
from tclight_torch.pipeline import postopt as po

torch.set_num_threads(2)


def _roll_ids(n, h, w, shift=3):
    base = np.arange(h * w).reshape(h, w)
    return np.stack([np.roll(base, -shift * t, axis=1) for t in range(n)]).reshape(n, h * w)


def _multi_band_ids(n, h, w, bands=3):
    hw = h * w
    ids = _roll_ids(n, h, w).copy()
    for g in range(1, bands):
        m = np.zeros(hw, bool)
        m[g::bands] = True
        gen = np.arange(m.sum()) + g * (hw + 40_000) + 177
        for t in range(1, n):
            ids[t, np.roll(m, 3 * t * g)] = gen
    return ids


def _sparse_mixed_ids(n=3, h=8, w=512):
    hw = h * w
    ids = _roll_ids(n, h, w).copy()
    fresh = np.arange(hw // 32) + hw + 100
    ids[1, ::32] = fresh
    ids[2, 5::32] = fresh + hw // 32
    return ids


def _assert_plans_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("ids_fn", [lambda: _roll_ids(3, 8, 512), _sparse_mixed_ids,
                                    lambda: _multi_band_ids(3, 8, 512)])
def test_planners_match_jax(ids_fn):
    ids = ids_fn()
    _assert_plans_equal(bg.plan_banded_gather_rows(ids), jbg.plan_banded_gather_rows(ids))
    _assert_plans_equal(bg.plan_banded_gather_rows_robust(ids),
                        jbg.plan_banded_gather_rows_robust(ids))
    for k in (2, 3):
        _assert_plans_equal(bg.plan_banded_gather_rows_multi(ids, n_windows=k),
                            jbg.plan_banded_gather_rows_multi(ids, n_windows=k))
    for args in ((4096 * 3, 4096), (4096, 4096 * 6), (100, 100)):
        assert bg.banded_geometry(*args) == jbg.banded_geometry(*args)
    assert bg.frame_tiles(1000) == jbg.frame_tiles(1000)


def test_plain_k4_matches_xla():
    ids = _sparse_mixed_ids()
    ids[0, 50:60] = -1  # masked entries give zero rows
    seg, st, offs, _, _, ok = bg.plan_banded_gather_rows_robust(ids)
    assert ok and offs.dtype == np.int16
    table = np.random.default_rng(0).standard_normal((int(ids.max()) + 1, 3)).astype(np.float32)
    got = bg.banded_gather(torch.from_numpy(table), torch.from_numpy(st.reshape(-1)),
                           torch.from_numpy(offs.reshape(-1, 512)), 2048)
    ref = jbg.banded_gather_xla(jnp.asarray(table), jnp.asarray(st.reshape(-1)),
                                jnp.asarray(offs.reshape(-1, 512)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.numpy().reshape(-1, 3)[50:60].max() == 0 == got.numpy().reshape(-1, 3)[50:60].min()


def test_plain_k5_matches_xla():
    ids = _multi_band_ids(3, 8, 512)
    ids[0, 40:50] = -1
    seg, st, offs, _, _, ok = bg.plan_banded_gather_rows_multi(ids, n_windows=3)
    assert ok and st.shape[-1] == 3
    table = np.random.default_rng(1).standard_normal((int(ids.max()) + 1, 3)).astype(np.float32)
    got = bg.banded_gather_multi(torch.from_numpy(table), torch.from_numpy(st.reshape(-1, 3)),
                                 torch.from_numpy(offs.reshape(-1, 512)), 2048)
    ref = jbg.banded_gather_xla_multi(jnp.asarray(table), jnp.asarray(st.reshape(-1, 3)),
                                      jnp.asarray(offs.reshape(-1, 512)), window=2048)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_plain_gathers_past_their_windows():
    """What K4/K5 write for offsets no window holds: the single-window
    version reads the table at starts + offs, the K-window one gives zero
    rows, as for a negative offset."""
    table = torch.arange(40 * 3, dtype=torch.float32).reshape(40, 3)
    offs = torch.tensor([[0, 7, 9, -1]], dtype=torch.int16)
    out = bg.banded_gather_plain(table, torch.tensor([2], dtype=torch.int32), offs)
    np.testing.assert_array_equal(out[0, :3].numpy(), table[[2, 9, 11]].numpy())
    assert (out[0, 3] == 0).all()
    out = bg.banded_gather_plain_multi(table, torch.tensor([[2, 20]], dtype=torch.int32),
                                       offs, 4)
    np.testing.assert_array_equal(out[0, :2].numpy(), table[[2, 23]].numpy())
    assert (out[0, 2:] == 0).all()


def test_pack_frames_addresses_frames_at_their_tile_base():
    x = torch.arange(2 * 300 * 3, dtype=torch.float32).reshape(2, 300, 3)
    packed = bg.pack_frames(x)
    base = bg.frame_tiles(300) * 128
    assert packed.shape == (2 * base, 3)
    np.testing.assert_array_equal(packed[base: base + 300].numpy(), x[1].numpy())
    assert (packed[300:base] == 0).all()


def test_cuda_wrappers_refuse_cpu_tensors():
    t = torch.zeros(10, 3)
    with pytest.raises(ValueError, match="CUDA"):
        bg.banded_gather_cuda(t, torch.zeros(1, dtype=torch.int32),
                              torch.zeros(1, 512, dtype=torch.int16), 2048)


@pytest.mark.parametrize("nb,rows,group", [(12, 1, 1), (12, 3, 1), (12, 4, 2), (24, 12, 2),
                                           (5, 5, 1), (32, 16, 2), (12, 6, 2)])
def test_block_order_is_a_permutation_by_index_within_rows(nb, rows, group):
    """K4's CTAs over a plan of `rows` leading rows: a CTA gathers block j of
    `group` consecutive rows (the largest power of two up to the kernel's
    K4_GROUP dividing rows), the CTAs of block j are consecutive, and
    together they gather every block once; one row keeps the plan's order,
    a CTA a block."""
    src = (Path(bg.__file__).resolve().parent.parent / "csrc" / "banded_gather.cu").read_text()
    assert f"constexpr int K4_GROUP = {bg.K4_GROUP};" in src
    order = bg.block_order(nb, rows)
    per = nb // rows
    assert order.shape == (nb // group, group)
    np.testing.assert_array_equal(np.sort(order.reshape(-1)), np.arange(nb))
    np.testing.assert_array_equal(order % per, np.repeat(np.arange(per), rows // group)[:, None]
                                  .repeat(group, 1))
    np.testing.assert_array_equal(np.diff(order // per, axis=1), 1)
    with pytest.raises(ValueError, match="rows"):
        bg.block_order(nb, nb + 1)


def test_block_order_groups_one_table_span_on_relabelled_tracks():
    """The render's premise: on kinematically relabelled tracks (tracks
    that break every frame, numbered by their mean scanline position) the
    frames' blocks of one index start within one window of each other, so
    the CTAs of one index in `block_order`, which run together, read one
    table span."""
    rng = np.random.default_rng(0)
    n, h, w = 4, 16, 256
    ids = np.stack([t * h * w + rng.permutation(h * w) for t in range(n)])
    inv = po.kinematic_relabel(ids, n * h * w)
    window, slope = bg.banded_geometry(n * h * w, h * w)
    _, st, _, _, _, ok = bg.plan_banded_gather_rows_robust(inv, window=window, slope=slope)
    assert ok
    # the CTAs of one block index, n / group of them, run together
    starts = st.reshape(-1)[bg.block_order(st.size, n)].reshape(-1, n)
    assert (starts.max(1) - starts.min(1) < window).all()


def test_ablate_postopt_k4_variants_apply_to_the_kernel():
    """`ablate_postopt`'s K4 variants for this kernel find their texts in
    its source, and each changes it."""
    from tclight_torch import ablate_postopt

    texts = ablate_postopt.variant_sources("K4", list(ablate_postopt.K4_VARIANTS))
    assert {"base", "noread", "sorted", "seq", "evict_last", "rows8", "c4"} <= set(texts)
    assert all(text != texts["base"] for name, text in texts.items() if name != "base")


def _c_params(source: str, entry: str) -> int:
    """The number of parameters of C entry point `entry` in a kernel source."""
    text = (Path(bg.__file__).resolve().parent.parent / "csrc" / source).read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
    assert m, entry
    return len(m.group(1).split(","))


@pytest.mark.parametrize("entry", ["tclight_banded_gather", "tclight_banded_gather_multi"])
def test_k4_k5_argtypes_match_the_c_entry_points(entry):
    """ctypes passes what `argtypes` says: one type per C parameter, or an
    argument is cut or shifted without an error."""
    assert len(bg._ENTRIES[entry]) == _c_params("banded_gather.cu", entry)


def _uvt_case():
    rng = np.random.default_rng(0)
    n, h, w = 4, 16, 256
    ids = _roll_ids(n, h, w).copy()
    ids[2, 100] = ids[2, 101]  # warp collisions -> the overflow path
    ids[3, 7] = ids[3, 8]
    p_pad = max(128, -(-(int(ids.max()) + 1) // 128) * 128)
    feats = rng.standard_normal((p_pad, 3)).astype(np.float32)
    return n, h, w, ids, p_pad, feats


def _tables(mod, ids, n, h, w, p_pad, allow_banded, **kw):
    mod._UVT_TABLE_CACHE.clear()
    return mod.build_uvt_tables(ids.reshape(-1), n, h, w, p_pad, allow_banded=allow_banded,
                                **kw)


@pytest.mark.parametrize("route", ["banded", "dense", "sorted"])
def test_uvt_routes_match_jax(route, monkeypatch):
    n, h, w, ids, p_pad, feats = _uvt_case()
    if route == "sorted":
        monkeypatch.setattr(po, "_DENSE_MAP_MAX_BYTES", 0)
        monkeypatch.setattr(jpo, "_DENSE_MAP_MAX_BYTES", 0)
    banded = route == "banded"
    tt, inv_t = _tables(po, ids, n, h, w, p_pad, banded, device="cpu")
    # JAX's banded route runs its Pallas kernels in interpret mode here
    tj, inv_j = _tables(jpo, ids, n, h, w, p_pad, banded)
    assert len(tt) == len(tj) == {"banded": 10, "dense": 4, "sorted": 3}[route]
    np.testing.assert_array_equal(inv_t, inv_j)
    for a, b in zip(tt, tj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx = np.array([1, 3, 0])
    ft = torch.from_numpy(feats).requires_grad_(True)
    out = po.uvt_gather(ft, tt, torch.from_numpy(idx), h * w)
    ref = jpo.uvt_gather(jnp.asarray(feats), tj, jnp.asarray(idx), hw=h * w)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    cot = np.random.default_rng(1).standard_normal((3, h * w, 3)).astype(np.float32)
    cot[:, 100:200] = 0.0  # rows touched only by zeros keep exact zeros
    out.backward(torch.from_numpy(cot))
    gj = jax.vjp(lambda f: jpo.uvt_gather(f, tj, jnp.asarray(idx), hw=h * w),
                 jnp.asarray(feats))[1](jnp.asarray(cot))[0]
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(gj), rtol=0, atol=1e-6)
    assert np.array_equal(ft.grad.numpy() == 0, np.asarray(gj) == 0)


def test_banded_tables_match_jax_plans():
    """The route choice and every banded plan array agree with JAX's, on
    single-window ids and on multi-band ids that need K = 3 windows."""
    for ids in (_uvt_case()[3], _multi_band_ids(3, 8, 512)):
        n, hw = ids.shape
        h, w = 8, hw // 8
        p_pad = max(128, -(-(int(ids.max()) + 1) // 128) * 128)
        tt, inv_t = _tables(po, ids, n, h, w, p_pad, True)
        tj, inv_j = _tables(jpo, ids, n, h, w, p_pad, True)
        assert len(tt) == len(tj) == 10
        np.testing.assert_array_equal(inv_t, inv_j)
        for a, b in zip(tt, tj):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tt[1].dim() == 3  # the multi-band ids took K-window plans


def test_uvt_multi_window_route_is_exact():
    """K-window banded route (plain K5 both ways) against the dense route."""
    ids = _multi_band_ids(3, 8, 512)
    n, hw = ids.shape
    p_pad = max(128, -(-(int(ids.max()) + 1) // 128) * 128)
    tb, _ = _tables(po, ids, n, 8, 512, p_pad, True)
    td, _ = _tables(po, ids, n, 8, 512, p_pad, False)
    assert len(tb) == 10 and tb[1].dim() == 3 and len(td) == 4
    feats = torch.from_numpy(np.random.default_rng(2).standard_normal((p_pad, 3))
                             .astype(np.float32))
    idx = torch.tensor([2, 0])
    before = kernels.STATS["banded_gather_multi"].launches
    fb, fd = (feats.clone().requires_grad_(True) for _ in range(2))
    ob, od = po.uvt_gather(fb, tb, idx, hw), po.uvt_gather(fd, td, idx, hw)
    np.testing.assert_array_equal(ob.detach().numpy(), od.detach().numpy())
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal((2, hw, 3))
                           .astype(np.float32))
    ob.backward(cot)
    od.backward(cot)
    np.testing.assert_allclose(fb.grad.numpy(), fd.grad.numpy(), rtol=0, atol=1e-5)
    assert kernels.STATS["banded_gather_multi"].launches == before  # plain on the CPU


def test_uvt_tables_fall_back_on_incoherent_ids():
    n, h, w = 2, 64, 1024
    base = np.arange(h * w, dtype=np.int32)
    ids = np.stack([base, (base * 1234567) % (h * w)])
    p_pad = max(128, -(-(int(ids.max()) + 1) // 128) * 128)
    tt, _ = _tables(po, ids, n, h, w, p_pad, True)
    tj, _ = _tables(jpo, ids, n, h, w, p_pad, True)
    assert len(tt) == len(tj) == 4
