"""heif_tpu_torch.ops.residual vs stage 1 of heif_tpu.ops.batch._core.

Each seeded class set of utils.residual_fuzz goes through the JAX stage
as `_core` runs it (J.residual_class per class, then its slot-grid
row-scatter, where every plane is a multiple of the class's size; its
blocks placed at their flat origins on every case) and through
the port's wrapper on CPU tensors, which runs the plain version
(residual_plain). Tolerance 0. The CUDA kernel runs only on a card
(tests/test_torch_card.py holds it against the plain version on the same
cases); here a numpy transcription of its own logic (the grid of
1,024-sample blocks over the class descriptors, the slot table that drops
cap-padding rows, the uint32 dequant that wraps as int32 does, the int32
transform sums, the in-place store by flat origin) is held against the
plain version on every case and on a packed plan. Also without CUDA: the
wrapper's argument checks, the byte and multiply-add counts, and that
`core` goes through the stage wrappers.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heif_tpu.ops import jax_recon as J
from heif_tpu_torch.ops import batch as B
from heif_tpu_torch.ops import recon as R
from heif_tpu_torch.ops import refsrc as RF
from heif_tpu_torch.ops import residual as RS
from heif_tpu_torch.tables import ReconTables
from heif_tpu_torch.utils import residual_fuzz as F
from heif_tpu_torch.utils.synthetic import synthetic_batch

PAD = R.PAD
TABLES = ReconTables.build()


def _jax_class(cls, sc, case):
    comp, size, coeffs, qp, dst, skip, byp, org = cls
    return np.asarray(J.residual_class(
        jnp.asarray(coeffs), jnp.asarray(qp), jnp.asarray(dst),
        jnp.asarray(skip), jnp.asarray(byp), jnp.asarray(sc[(size, comp)]),
        size, RS.bit_depth(case, comp)))


def jax_stage1(classes, sc, case):
    """Stage 1 of heif_tpu.ops.batch._core (its lines 469-501): per class
    J.residual_class, then the dense slot grid and depth-to-space, the
    class planes added and padded. It needs every plane to be a multiple
    of its classes' sizes."""
    n = case.n
    dims = RS.plane_dims(case)
    res = [jnp.zeros((n, h, w), jnp.int32) for h, w in dims]
    for cls in classes:
        comp, size, org = cls[0], cls[1], jnp.asarray(cls[7])
        r = jnp.asarray(_jax_class(cls, sc, case))
        h, w = dims[comp]
        gh, gw = h // size, w // size
        stride = (h + PAD) * (w + PAD)
        ti = org // stride
        rem = org % stride
        oy = rem // (w + PAD)
        ox = rem % (w + PAD)
        slot = ti * (gh * gw) + (oy // size) * gw + (ox // size)
        slot = jnp.where(org < 0, n * gh * gw, slot)
        grid = jnp.zeros((n * gh * gw + 1, size * size), jnp.int32)
        grid = grid.at[slot].set(r.reshape(-1, size * size))
        plane = (grid[: n * gh * gw].reshape(n, gh, gw, size, size)
                 .transpose(0, 1, 3, 2, 4).reshape(n, h, w))
        res[comp] = res[comp] + plane
    return [np.asarray(jnp.pad(p, ((0, 0), (0, PAD), (0, PAD)))) for p in res]


def jax_flat(classes, sc, case):
    """J.residual_class per class, its real rows (org >= 0) placed at
    their flat origins (numpy; any plane size)."""
    out = []
    for comp, (h, w) in enumerate(RS.plane_dims(case)):
        flat = np.zeros(case.n * (h + PAD) * (w + PAD), np.int32)
        for cls in classes:
            if cls[0] != comp:
                continue
            s, real = cls[1], cls[7] >= 0
            r = _jax_class(cls, sc, case)[real]
            idx = (cls[7][real, None, None] + np.arange(s)[:, None] * (w + PAD)
                   + np.arange(s))
            flat[idx] = r
        out.append(flat.reshape(case.n, h + PAD, w + PAD))
    return out


# a numpy transcription of csrc/residual.cu

THREADS = 256  # a block
CU = Path(RS.__file__).resolve().parent.parent / "csrc" / "residual.cu"


def _cu_table(name):
    """The integers of a __constant__ table of csrc/residual.cu."""
    body = re.search(rf"__constant__ int32_t {name}\[\d+\] = \{{([^}}]*)\}}",
                     CU.read_text()).group(1)
    return np.array([int(v) for v in body.replace("\n", " ").split(",")],
                    np.int64)


K_COS, K_DST4, K_LEVEL_SCALE = (_cu_table(n) for n in
                                ("kCos", "kDst4", "kLevelScale"))
FITS = 2 ** 31  # every sum the kernel forms must fit int32


def _cos_at(m):
    m &= 127
    if m > 64:
        m = 128 - m
    return int(K_COS[m]) if m <= 32 else -int(K_COS[64 - m])


def coef(n_pts, k, n):
    """T_N[k][n] as the kernel derives it from kCos."""
    return _cos_at((32 // n_pts) * k * (2 * n + 1))


def idct(x, km):
    """Idct<N, KM>::run on the last axis of x (int64): the partial
    butterfly, inputs k >= km known zero and left out; every partial sum
    checked to fit int32."""
    n_pts = x.shape[-1]
    assert not x[..., km:].any(), "a skipped input is not zero"
    if n_pts == 1:
        return 64 * x if km > 0 else 0 * x
    h = n_pts // 2
    e = idct(x[..., 0::2], (km + 1) // 2)
    o = np.zeros_like(e)
    for n in range(h):
        for k in range(1, km, 2):
            o[..., n] += coef(n_pts, k, n) * x[..., k]
            assert np.abs(o[..., n]).max(initial=0) < FITS
    out = np.concatenate([e + o, (e - o)[..., ::-1]], -1)
    assert np.abs(out).max(initial=0) < FITS
    return out


def idst4(x):
    return x @ K_DST4.reshape(4, 4)


def transform(s, mode, used, x):
    """transform<S>: DST-4, else the smallest of Idct<S, S/4>, <S, S/2>,
    <S, S> that covers `used` leading inputs."""
    if s == 4 and mode == 1:
        return idst4(x)
    km = s // 4 if used <= s // 4 else s // 2 if used <= s // 2 else s
    return idct(x, km)


def _clip16(v):
    return np.clip(v, -32768, 32767)


def launch_order(classes):
    """(class index, first block) in the launcher's order: sizes 32 to 4,
    each class a run of ceil(k / (256 / S)) blocks."""
    order, blocks = [], 0
    for size in (32, 16, 8, 4):
        for i, cls in enumerate(classes):
            if cls[1] == size:
                order.append((i, blocks))
                blocks += -(-cls[2].shape[0] // (THREADS // size))
    return order, blocks


def kernel_model(classes, sc, case, buckets=None):
    """What residual_kernel writes, block by block in the launcher's
    order: per block the TU slots (org < 0 or past the class: no field
    read, nothing written), the dequant of each level in uint32 cast to
    int32, then per warp (32 / S TUs) the rows and columns that hold a
    nonzero level, the column pass on that many leading rows and the row
    pass on that many leading columns (partial butterflies, or DST-4),
    skip and bypass, and the row stores at org + i * pitch into
    zero-filled planes. buckets: a dict that counts the Idct<S, KM>
    instantiations the warps pick, per pass."""
    dims = RS.plane_dims(case)
    planes = [np.zeros(case.n * (h + PAD) * (w + PAD), np.int32)
              for h, w in dims]
    order, n_blocks = launch_order(classes)
    for b in range(n_blocks):
        ci, fb = [o for o in order if o[1] <= b][-1]  # the kernel's scan
        comp, s, coeffs, qp, dst, skip, byp, org = classes[ci]
        bd = RS.bit_depth(case, comp)
        log2 = s.bit_length() - 1
        pitch = dims[comp][1] + PAD
        tpb = THREADS // s
        tu0 = (b - fb) * tpb
        slots, mode, d = [], np.zeros(tpb, int), np.zeros((tpb, s, s),
                                                           np.int64)
        for t in range(tpb):
            tu = tu0 + t
            o = int(org[tu]) if tu < coeffs.shape[0] else -1
            slots.append(o)
            if o < 0:
                mode[t] = 2  # no transform, nothing stored
                continue
            e = int(qp[tu]) // 6
            mode[t] = (3 if byp[tu] else 2 if skip[tu]
                       else 1 if s == 4 and dst[tu] else 0)
            lvl = coeffs[tu].astype(np.int64)
            if mode[t] == 3:
                d[t] = lvl
                continue
            p = (lvl.astype(np.uint32) * sc[(s, comp)].astype(np.uint32)
                 * np.uint32(K_LEVEL_SCALE[int(qp[tu]) - 6 * e]))
            sh = bd + log2 - 5 - e
            if sh > 0:
                lo = ((p + np.uint32(1 << (sh - 1))).view(np.int32)
                      .astype(np.int64) >> sh)
            else:
                lo = (p << np.uint32(-sh)).view(np.int32).astype(np.int64)
            d[t] = _clip16(lo)
        g = d.copy()
        used = {}
        for w0 in range(0, tpb, max(32 // s, 1)):  # a warp's TUs
            tus = range(w0, w0 + max(32 // s, 1))
            nz = d[list(tus)] != 0  # [TUs, rows, cols]
            rows = max((r + 1 for r in range(s) if nz[:, r].any()), default=0)
            cols = max((c + 1 for c in range(s) if nz[:, :, c].any()),
                       default=0)
            for t in tus:
                used[t] = cols
                if mode[t] <= 1:
                    # columns: x[k] = D[k][j] for each column j
                    y = transform(s, mode[t], rows, d[t].T)
                    g[t] = _clip16((y.T + 64) >> 7)
            if buckets is not None and any(mode[t] == 0 for t in tus):
                for name, k in (("rows", rows), ("cols", cols)):
                    km = s // 4 if k <= s // 4 else s // 2 if k <= s // 2 else s
                    buckets[(name, s, km)] = buckets.get((name, s, km), 0) + 1
        rnd, sh = 1 << (19 - bd), 20 - bd
        for t, o in enumerate(slots):
            if o < 0:
                continue
            if mode[t] == 3:
                r = g[t]
            elif mode[t] == 2:
                r = _clip16((g[t] * 128 + rnd) >> sh)
            else:
                r = _clip16((transform(s, mode[t], used[t], g[t]) + rnd) >> sh)
            idx = o + np.arange(s)[:, None] * pitch + np.arange(s)[None]
            planes[comp][idx] = r
    return [p.reshape(case.n, h + PAD, w + PAD)
            for p, (h, w) in zip(planes, dims)]


def _divisible(case):
    return all(h % s == 0 and w % s == 0 for comp, s in F.CLASSES
               for h, w in [RS.plane_dims(case)[comp]])


@pytest.mark.parametrize("case", F.CASES, ids=lambda c: f"seed{c.seed}")
def test_residual_planes_equal_the_jax_stage(case):
    classes, sc = F.inputs(case)
    d = F.tensors(case, "cpu")
    RS.reset_launches()
    got = [p.numpy() for p in RS.residual_planes(d, case)]
    assert RS.LAUNCHES == {"residual": 0}  # no kernel on the CPU
    wants = [jax_flat(classes, sc, case)]
    if _divisible(case):
        wants.append(jax_stage1(classes, sc, case))
    else:
        assert case.seed == 4  # 72x40: the slot grid cannot hold it
    for want in wants:
        for c in range(3):
            assert got[c].dtype == np.int32
            np.testing.assert_array_equal(got[c], want[c], err_msg=str(c))


@pytest.mark.parametrize("case", F.CASES, ids=lambda c: f"seed{c.seed}")
def test_kernel_model_equals_plain(case):
    classes, sc = F.inputs(case)
    want = RS.residual_plain(F.tensors(case, "cpu"), case)
    got = kernel_model(classes, sc, case)
    for c in range(3):
        np.testing.assert_array_equal(got[c], want[c].numpy(), err_msg=str(c))


def _plan(seed=5, height=96):
    bp = B.pack_batch(*synthetic_batch(n=3, size=64, height=height, bd=8,
                                       pcm=True, seed=seed))
    return bp, B.plan_to_device(bp, torch.device("cpu"))


def test_kernel_model_on_a_packed_plan():
    """A plan as pack_batch makes it (classes in CLASSES order, PCM
    tiles): the model, the plain version and the JAX stage agree."""
    bp, d = _plan()
    classes = [(c, s, *(t.numpy() for t in rest))
               for c, s, *rest in d["classes"]]
    sc = {k: v.numpy() for k, v in d["scaling"].items()}
    want = RS.residual_planes(d, bp)
    for other in (kernel_model(classes, sc, bp), jax_stage1(classes, sc, bp)):
        for c in range(3):
            np.testing.assert_array_equal(other[c], want[c].numpy())


def test_kernel_tables_are_hevcs():
    """The tables compiled into csrc/residual.cu are tables.ReconTables':
    T_S[k][n] from kCos for every size, DST-4 and the level scales."""
    for s in RS.SIZES:
        t = np.array([[coef(s, k, n) for n in range(s)] for k in range(s)])
        np.testing.assert_array_equal(t, TABLES.dct(s).numpy(), err_msg=str(s))
    np.testing.assert_array_equal(K_DST4.reshape(4, 4), TABLES.dst4.numpy())
    np.testing.assert_array_equal(K_LEVEL_SCALE, TABLES.level_scale.numpy())


# (size, inputs that may be nonzero): every Idct<S, KM> the kernel
# instantiates, and DST-4 (km None)
BUTTERFLIES = [(s, km) for s in RS.SIZES
               for km in (max(s // 4, 1), s // 2, s)] + [(4, None)]


@pytest.mark.parametrize("s,km", BUTTERFLIES,
                         ids=lambda v: "dst" if v is None else str(v))
def test_butterfly_equals_the_direct_product(s, km):
    """The partial butterfly of the kernel (Idct<S, KM>, or DST-4) equals
    T^T x, the direct product of ops.recon, on saturated inputs: every
    sign pattern of +-32768 in the first KM inputs that maximises an
    output, all +-32768, and random ones; no partial sum leaves int32."""
    rng = np.random.default_rng(s * 100 + (km or 0))
    t = (TABLES.dst4 if km is None else TABLES.dct(s)).numpy().astype(np.int64)
    k = 4 if km is None else km
    worst = 32768 * np.sign(t[:k].T)  # [n, k]: the sign of each product
    xs = np.concatenate([worst, -worst, np.full((1, k), 32768),
                         np.full((1, k), -32768),
                         rng.choice(np.array([-32768, 32767]), (64, k)),
                         rng.integers(-32768, 32768, (64, k))])
    x = np.zeros((len(xs), s), np.int64)
    x[:, :k] = xs
    got = idst4(x) if km is None else idct(x, km)
    np.testing.assert_array_equal(got, x @ t)
    # the worst sign patterns reach the largest sum these inputs allow
    assert np.abs(got).max() == 32768 * np.abs(t[:k]).sum(0).max()


def test_zero_skip_on_corner_levels():
    """On the fuzz cases with levels in a TU corner, the model's warps
    pick every Idct<S, KM> of both passes for every size, and it still
    equals the plain version (test_kernel_model_equals_plain)."""
    seen = {}
    for case in F.CASES:
        if case.corner:
            kernel_model(*F.inputs(case), case, seen)
    want = {(name, s, km) for name in ("rows", "cols") for s in RS.SIZES
            for km in (max(s // 4, 1), s // 2, s)}
    assert set(seen) == want


def test_fuzz_covers_the_contract():
    """Every class has real and padding rows somewhere; DST, skip and
    bypass occur both ways on real rows; qp spans 0-63; saturated levels
    make the shifted dequant product wrap past int32."""
    real = {k: 0 for k in F.CLASSES}
    pad = dict(real)
    dst, skip, byp, qps, wraps = set(), set(), set(), set(), 0
    for case in F.CASES:
        classes, sc = F.inputs(case)
        for comp, size, coeffs, qp, d, sk, by, org in classes:
            r = org >= 0
            real[(comp, size)] += int(r.sum())
            pad[(comp, size)] += int((~r).sum())
            if size == 4:
                dst |= set(d[r].tolist())
            skip |= set(sk[r].tolist())
            byp |= set(by[r].tolist())
            qps |= set(qp[r].tolist())
            bd = RS.bit_depth(case, comp)
            e = qp[r] // 6 - (bd + int(np.log2(size)) - 5)
            prod = (np.abs(coeffs[r].astype(np.int64)).max(axis=(1, 2))
                    * sc[(size, comp)].max() * 72)
            wraps += int(((e > 0) & (prod << np.maximum(e, 0) >= 2 ** 31))
                         .sum())
    assert min(real.values()) > 0 and min(pad.values()) > 0
    assert dst == skip == byp == {False, True}
    assert qps == set(range(64))
    assert wraps > 0
    assert {c.bit_depth_y for c in F.CASES} >= {8, 10, 12}
    assert {c.lists for c in F.CASES} == {"flat", "default", "random"}


def _bad(kind: str):
    case = F.CASES[0]
    d = F.tensors(case, "cpu")
    cls = list(d["classes"][0])
    if kind == "coeffs_dtype":
        cls[2] = cls[2].to(torch.int32)
    elif kind == "coeffs_shape":
        cls[2] = cls[2][:, :2].contiguous()
    elif kind == "qp_dtype":
        cls[3] = cls[3].long()
    elif kind == "flag_dtype":
        cls[5] = cls[5].to(torch.uint8)
    elif kind == "org_count":
        cls[7] = cls[7][1:].contiguous()
    elif kind == "org_layout":
        cls[7] = cls[7].repeat_interleave(2)[::2]
    elif kind == "size":
        cls[1] = 64
    elif kind == "comp":
        cls[0] = 3
    elif kind == "scaling_dtype":
        d["scaling"][(4, 0)] = d["scaling"][(4, 0)].to(torch.int16)
    elif kind == "too_many":
        d["classes"] = d["classes"] * 2
    elif kind == "bit_depth":
        case = dataclasses.replace(case, bit_depth_c=7)
    elif kind == "device":
        d = {"classes": [(c, s, *(t.to("meta") for t in rest))
                         for c, s, *rest in d["classes"]],
             "scaling": {k: v.to("meta") for k, v in d["scaling"].items()},
             "steps": [t.to("meta") for t in d["steps"]]}
        return d, case
    if kind != "too_many":
        d["classes"][0] = tuple(cls)
    return d, case


BAD = ("coeffs_dtype", "coeffs_shape", "qp_dtype", "flag_dtype", "org_count",
       "org_layout", "size", "comp", "scaling_dtype", "too_many", "bit_depth",
       "device")


@pytest.mark.parametrize("kind", BAD)
def test_wrapper_raises_on_bad_arguments(kind):
    """The checks run before any build or launch, so they hold without
    CUDA; nothing is counted."""
    d, case = _bad(kind)
    RS.reset_launches()
    with pytest.raises((TypeError, ValueError)):
        RS.residual_planes(d, case)
    assert RS.LAUNCHES == {"residual": 0}


def test_residual_bytes_and_macs():
    """Two 4x4 rows (one padding) and one 8x8 skip row on one 8x8 tile:
    planes (40*40 + 2*36*36) * 4 bytes written; levels, qp and flags of
    the two real rows, three origins, two scaling matrices; the two
    butterfly passes (4 columns, 4 rows, 8 multiply-adds each) of the one
    transformed 4x4 row."""
    case = F.Case(0, 1, 8, 8)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    flags = lambda v: torch.tensor(v, dtype=torch.bool)  # noqa: E731
    d = {"classes": [
        (0, 4, torch.zeros((2, 4, 4), dtype=torch.int16), i32([1, 2]),
         flags([1, 1]), flags([0, 0]), flags([0, 0]), i32([0, -1])),
        (0, 8, torch.zeros((1, 8, 8), dtype=torch.int16), i32([3]),
         flags([0]), flags([1]), flags([0]), i32([0])),
    ], "scaling": {(4, 0): torch.zeros((4, 4), dtype=torch.int32),
                   (8, 0): torch.zeros((8, 8), dtype=torch.int32)},
        "steps": [torch.zeros((1, 0, 6), dtype=torch.int32)] * 3}
    planes = (40 * 40 + 2 * 36 * 36) * 4
    rows = (16 * 2 + 7) + (64 * 2 + 7)
    assert RS.residual_bytes(d, case) == planes + rows + 3 * 4 + (16 + 64) * 4
    assert RS.residual_macs(d, case) == 2 * 4 * 8


def test_core_goes_through_the_stage_wrappers(monkeypatch):
    """core hands the plan to residual.residual_planes once and both
    worklists to refsrc.ref_sources2 once, and walks on what they
    return."""
    bp, d = _plan(seed=9, height=64)
    cpu = torch.device("cpu")
    want = B.core(d, bp, cpu)
    calls = []

    def spy(name, fn):
        def run(*args, **kw):
            calls.append((name, kw.get("comp")))
            return fn(*args, **kw)
        return run

    monkeypatch.setattr(RS, "residual_planes",
                        spy("residual", RS.residual_planes))
    monkeypatch.setattr(RF, "ref_sources2",
                        spy("ref_sources2", RF.ref_sources2))
    got = B.core(d, bp, cpu)
    assert calls == [("residual", None), ("ref_sources2", None)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
