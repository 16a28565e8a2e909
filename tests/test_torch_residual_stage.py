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

SAMPLES = 1024  # samples a block


def _clip16(v):
    return np.clip(v, -32768, 32767)


def kernel_model(classes, sc, case):
    """What residual_kernel writes: the launcher's block runs per class,
    then per block its slot table (cap-padding rows and slots past the
    class: -1, no field read), dequant in uint32 cast back to int32, the
    column and row stages summed in int64 and checked to fit int32 (the
    kernel sums in int32), skip and bypass, and the store at org + i *
    pitch + j into zero-filled planes."""
    dims = RS.plane_dims(case)
    planes = [np.zeros(case.n * (h + PAD) * (w + PAD), np.int32)
              for h, w in dims]
    first, blocks = [], 0
    for cls in classes:
        first.append(blocks)
        blocks += -(-cls[2].shape[0] // (SAMPLES // cls[1] ** 2))
    first.append(blocks)
    ls = TABLES.level_scale.numpy().astype(np.int64)
    for b in range(blocks):
        ci = 0
        while ci + 1 < len(classes) and b >= first[ci + 1]:
            ci += 1
        comp, s, coeffs, qp, dst, skip, byp, org = classes[ci]
        bd = RS.bit_depth(case, comp)
        pitch = dims[comp][1] + PAD
        tus = SAMPLES // (s * s)
        slots = [tu if tu < coeffs.shape[0] and org[tu] >= 0 else -1
                 for tu in range((b - first[ci]) * tus,
                                 (b - first[ci] + 1) * tus)]
        t_dct = TABLES.dct(s).numpy().astype(np.int64)
        bd_shift = bd + int(np.log2(s)) - 5
        for tu in slots:
            if tu < 0:
                continue
            lvl = coeffs[tu].astype(np.int64)
            e, m6 = divmod(int(qp[tu]), 6)
            v = (lvl.astype(np.uint32) * sc[(s, comp)].astype(np.uint32)
                 * np.uint32(ls[m6]))
            if e < bd_shift:
                lo = (v.view(np.int32).astype(np.int64)
                      + (1 << (bd_shift - e - 1))) >> (bd_shift - e)
            else:
                lo = (v << np.uint32(e - bd_shift)).view(np.int32).astype(
                    np.int64)
            d = _clip16(lo)
            t = (TABLES.dst4.numpy().astype(np.int64)
                 if s == 4 and dst[tu] else t_dct)
            g = t.T @ d
            assert np.abs(g).max(initial=0) < 2 ** 31
            g = _clip16((g + 64) >> 7)
            r = g @ t
            assert np.abs(r).max(initial=0) < 2 ** 31
            out = _clip16((r + (1 << (19 - bd))) >> (20 - bd))
            if byp[tu]:
                out = lvl
            elif skip[tu]:
                out = _clip16(((d << 7) + (1 << (19 - bd))) >> (20 - bd))
            idx = (int(org[tu]) + np.arange(s)[:, None] * pitch
                   + np.arange(s)[None])
            planes[comp][idx] = out
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
    """core hands the plan to residual.residual_planes once and each
    worklist to refsrc.ref_sources (luma, then chroma), and walks on what
    they return."""
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
    monkeypatch.setattr(RF, "ref_sources", spy("ref_sources", RF.ref_sources))
    got = B.core(d, bp, cpu)
    assert calls == [("residual", None), ("ref_sources", 0),
                     ("ref_sources", 1)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
