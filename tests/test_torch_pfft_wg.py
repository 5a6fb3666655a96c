"""K3's three passes in the bf16 modes as the ``wgmma`` kernels compute them.

``csrc/pfft_conv_wg.cu``'s passes 2 and 3 round what the plain version
(``rows_combine_plain``, ``cols_inv_plain``) and the JAX package round:
each product's data operand and the stage matrix ``mf[k2]`` or
``mi[k2]`` of its ``k2``. They take each table as its real and
imaginary planes (``wg_stage_tables``), a complex row as its real then
its imaginary parts, and the sign of ``wgmma``'s A operand, and they sum
over ``k2`` in rounds of 9. Pass 1 rounds what the plain version
(``cols_fwd_plain``) rounds: stage A in float32 ends with the twiddle
``tw[k2][n1] = mf[k2][n1, 0]``, and every ``k2`` multiplies the one
128-point DFT ``F = mf[0]``, whose planes the kernel keeps in shared
memory (``wg_stage_tables(m)[0, 0]``), where the JAX package's
``_k1_body`` rounds each ``mf[k2]``. This file holds that arithmetic,
written out in PyTorch, against the plain version, float64 and (pass 1)
the JAX package's kernel; the tables' layout against the plain
version's split planes; the wrappers' routing; and the JAX package's
Hessian action that ``tests/test_torch_gpu.py`` holds the card's
against. Tolerances, each with its reason:

- the tables are the split planes exactly, and the planar product of
  one ``k2`` is the interleaved one to float32 summation order (1e-6 of
  the max-abs);
- a pass written out as the kernel computes it is the plain version to
  summation order plus the roundings that order moves: within a tenth
  of the mode's documented error (``3.1e-5`` and ``1.3e-2`` of the
  max-abs, ``tests/test_torch_pfft_split.py`` and
  ``tests/test_torch_default_dial.py``);
- pass 1 so written against float64 as ``chip_smoke.py`` phase 2 holds
  the card's kernel (``split_anchored``, ``bf16_anchored``: within twice
  the mode's plain version's error plus 1e-6 of the max-abs, under
  ``"split"`` also within 1e-4 of it, under ``"bf16"`` at least half the
  plain version's error), and against the JAX package's ``_k1_body`` in
  the interpreter within the mode's documented error (the two round
  other operands: one ``F`` and a twiddled ``S`` here, each ``mf[k2]``
  and Karatsuba's sums there);
- the recorded Hessian action is the JAX package's to a thousandth of
  its bar.
"""

import contextlib
import types

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax
import jax.numpy as jnp

import chip_smoke
from jolideco_torch.ops import pallas_fft as pf
from jolideco_tpu.ops import pallas_fft as jpf
from test_torch_gpu import PFFT_HVP_JAX, pfft_hvp_case, pfft_hvp_port
from test_torch_pfft_split import jax_cols_fwd_split

torch.set_num_threads(1)
SPLIT_BAR = 3.1e-5
BF16_BAR = 1.3e-2
ROUND = 9  # the kernels' k2 a round


def unpack(m):
    """:func:`pf.wg_stage_tables` back to float32 ``(2, m, hl, part, b,
    k1)``: for ``mf`` and ``mi``, per ``k2``, the hi and lo planes of the
    real and imaginary parts of ``M^T``, through the address map of the
    kernels' descriptors (``[c][hl][part][rg][kb][ri][ki]`` a chunk)."""
    t = pf.wg_stage_tables(m).float()
    x = t.reshape(2, m, 4, 2, 2, 16, 4, 8, 8)  # t k2 c hl part rg kb ri ki
    return x.permute(0, 1, 3, 4, 5, 7, 2, 6, 8).reshape(2, m, 2, 2, 128, 128)


def planar_product(x, tab, mode):
    """``x . M`` for complex ``x`` ``(..., 128)`` as the kernels take it:
    the real and imaginary parts of ``x`` split (``"split"``) or rounded
    (``"bf16"``), ``tab`` ``(hl, part, b, k1)``, ``Re z = x_re Re M -
    x_im Im M``, ``Im z = x_re Im M + x_im Re M``, the products hi.hi +
    hi.lo + lo.hi or hi.hi."""
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    if mode == "split":
        xr, xi = pf.bf16_split(xr), pf.bf16_split(xi)
        pairs = ((1, 0), (0, 1), (0, 0))  # (A's plane, B's part)
    else:
        xr, xi = (pf.bf16_round(xr),), (pf.bf16_round(xi),)
        pairs = ((0, 0),)
    re = im = 0
    for a, b in pairs:
        are, aim = tab[a, 0].T, tab[a, 1].T
        re = re + xr[b] @ are - xi[b] @ aim
        im = im + xr[b] @ aim + xi[b] @ are
    return torch.complex(re, im)


def rows_as_the_kernel(u, a_re, a_im, b2_re, b2_im, conj_spec, mode):
    """Pass 2 as ``pfft_rows_wg_kernel`` computes it: per round of up to
    9 ``k2``, ``Z = X mf[k2]``, ``P = [A . Z; conj(B2) . Z] mi[k2]``, the
    round's sum over ``k2`` by ``wi`` added to the rounds before."""
    p_, n, w = u.shape
    m, wb = n // 128, w // 128
    t = pf._plain_tables(m, torch.float32, u.device)
    tab = unpack(m)
    s = torch.einsum("qk,prqi->prki", t["wf"][:wb],
                     u.reshape(p_, n, wb, 128))
    sign = -1.0 if conj_spec else 1.0
    a = torch.complex(a_re, sign * a_im).reshape(p_, n, m, 128)
    b2 = torch.complex(b2_re, sign * b2_im).reshape(p_, n, m, 128)
    v1 = torch.zeros((p_, n, wb, 128), dtype=torch.complex64)
    v2 = torch.zeros_like(v1)
    for k0 in range(0, m, ROUND):
        s1 = s2 = 0
        for k2 in range(k0, min(m, k0 + ROUND)):
            z = planar_product(s[:, :, k2], tab[0, k2], mode)
            p1 = planar_product(a[:, :, k2] * z, tab[1, k2], mode)
            p2 = planar_product(b2[:, :, k2].conj() * z, tab[1, k2], mode)
            wi = t["wi"][:wb, k2][:, None]
            s1 = s1 + wi * p1[:, :, None]
            s2 = s2 + wi * p2[:, :, None]
        v1 = v1 + s1
        v2 = v2 + torch.conj_physical(s2)
    return v1.reshape(p_, n, w), v2.reshape(p_, n, w)


def cols_inv_as_the_kernel(v1, v2, h, mode):
    """Pass 3 as ``pfft_cols_inv_wg_kernel`` computes it: per round,
    ``[V1 + conj V2; V1 - conj V2]`` of each ``k2`` block times
    ``mi[k2]``, summed over the round's ``k2`` by ``wi``."""
    p_, n, w = v1.shape
    m, hb = n // 128, h // 128
    t = pf._plain_tables(m, torch.float32, v1.device)
    tab = unpack(m)
    xp = (v1 + v2.conj()).reshape(p_, m, 128, w).transpose(-1, -2)
    xm = (v1 - v2.conj()).reshape(p_, m, 128, w).transpose(-1, -2)
    y0 = torch.zeros((p_, hb, 128, w))
    y1 = torch.zeros_like(y0)
    for k0 in range(0, m, ROUND):
        sp = sm = 0
        for k2 in range(k0, min(m, k0 + ROUND)):
            wi = t["wi"][:hb, k2][:, None, None]
            sp = sp + wi * planar_product(xp[:, k2], tab[1, k2],
                                          mode).transpose(-1, -2)[:, None]
            sm = sm + wi * planar_product(xm[:, k2], tab[1, k2],
                                          mode).transpose(-1, -2)[:, None]
        y0 = y0 + sp.real
        y1 = y1 + sm.imag
    return y0.reshape(p_, h, w), y1.reshape(p_, h, w)


def cols_fwd_as_the_kernel(x0, x1, n, mode):
    """Pass 1 as ``pfft_cols_fwd_wg_kernel`` computes it: stage A in
    float32 (the sum over ``n2`` in order, then the twiddle ``tw[k2][n1]
    = mf[k2][n1, 0]``), then for every ``k2`` the rows ``S'^T`` times
    ``F = mf[0]``, its planes read back from the table the kernel keeps
    (:func:`unpack`, ``[0, 0]``), with ``wgmma``'s sign on A, k16 step by
    k16 step in the order the kernel issues its products."""
    p_, h, w = x0.shape
    m, hb = n // 128, h // 128
    t = pf._plain_tables(m, torch.float32, x0.device)
    f = unpack(m)[0, 0]  # (hl, part, k1, n1)
    z = torch.complex(x0, x1).reshape(p_, hb, 1, 128, w)
    s = 0
    for n2 in range(hb):
        s = s + t["wf"][n2][:, None, None] * z[:, n2]
    s = s * t["mf"][:, :, :1]  # (P, m, 128 n1, W)
    x = s.transpose(-1, -2)  # the operand rows (P, m, W, 128 n1)
    if mode == "split":
        xr, xi = pf.bf16_split(x.real.contiguous()), pf.bf16_split(
            x.imag.contiguous())
        pairs = ((1, 0), (0, 1), (0, 0))  # (A's plane, B's part)
    else:
        xr, xi = (pf.bf16_round(x.real.contiguous()),), (
            pf.bf16_round(x.imag.contiguous()),)
        pairs = ((0, 0),)
    re = torch.zeros(x.shape)
    im = torch.zeros(x.shape)
    for k in range(0, 128, 16):
        ks = slice(k, k + 16)
        # Re U = s_re Re F - s_im Im F;  Im U = s_re Im F + s_im Re F
        for acc, sign, part, xs in ((re, 1.0, 0, xr), (re, -1.0, 1, xi),
                                    (im, 1.0, 1, xr), (im, 1.0, 0, xi)):
            for a, b in pairs:
                acc += sign * (xs[b][..., ks] @ f[a, part][:, ks].T)
    u = torch.complex(re, im).transpose(-1, -2)
    return u.reshape(p_, n, w)


@pytest.mark.parametrize("m", [1, 2, 9])
def test_wg_stage_tables_are_the_split_planes(m):
    """Each table is the hi and lo planes of the plain version's
    interleaved ``R`` (``R[2 k, 2 b] = Re M``, ``R[2 k, 2 b + 1] = Im
    M``), transposed, chunk by chunk as a bulk copy lays it."""
    tab = unpack(m)
    assert tuple(pf.wg_stage_tables(m).shape) == (2, m, 4, 16384)
    for i, name in enumerate(("mf", "mi")):
        r = torch.as_tensor(pf.interleaved_stage_matrices(m)[name])
        for hl, plane in enumerate(pf.bf16_split(r)):
            assert torch.equal(tab[i, :, hl, 0],
                               plane[:, 0::2, 0::2].transpose(-1, -2))
            assert torch.equal(tab[i, :, hl, 1],
                               plane[:, 0::2, 1::2].transpose(-1, -2))


@pytest.mark.parametrize("mode", ["split", "bf16"])
def test_planar_product_is_the_interleaved_product(mode):
    """One ``k2``'s product from the planar tables with A's sign is the
    plain version's product of interleaved rows with the split ``R``."""
    m = 3
    rng = np.random.default_rng(7)
    x = torch.complex(*(torch.as_tensor(rng.standard_normal((2, m, 40, 128))
                                        .astype(np.float32))
                        for _ in range(2)))
    tab = unpack(m)
    for i, name in enumerate(("mf", "mi")):
        want = pf._tc_product(x, pf._mode_tables(m, x.device, mode)[name])
        got = torch.stack([planar_product(x[:, k2], tab[i, k2], mode)
                           for k2 in range(m)], dim=1)
        scale = float(want.abs().max())
        assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("mode", ["split", "bf16"])
@pytest.mark.parametrize("m,conj_spec", [(3, False), (12, True)])
def test_passes_as_the_kernels_compute_them(mode, m, conj_spec):
    """Passes 2 and 3 written out as the kernels compute them (at m = 12
    two rounds, the second added to the first) against the plain
    version in the same mode."""
    n, w = 128 * m, 256
    rng = np.random.default_rng(m)
    u = torch.complex(*(torch.as_tensor(rng.standard_normal((1, n, w))
                                        .astype(np.float32))
                        for _ in range(2)))
    planes = [torch.as_tensor(rng.standard_normal((1, n, n))
                              .astype(np.float32)) for _ in range(4)]
    bar = 0.1 * (SPLIT_BAR if mode == "split" else BF16_BAR)
    v = rows_as_the_kernel(u, *planes, conj_spec, mode)
    want = pf.rows_combine_plain(u, *planes, conj_spec, mode=mode)
    for got, ref in zip(v, want):
        scale = float(ref.abs().max())
        assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=bar * scale)
    y = cols_inv_as_the_kernel(*want, 256, mode)
    for got, ref in zip(y, pf.cols_inv_plain(*want, 256, mode=mode)):
        scale = float(ref.abs().max())
        assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=bar * scale)


# pass 1's cases: m = 2, 9 (the main path's n = 1152) and 17 (the x2
# path's n = 2176), each image smaller than its transform
PASS1_CASES = {2: (2, 128, 128), 9: (1, 256, 128), 17: (1, 256, 128)}


@pytest.fixture(scope="module")
def pass1_jax():
    """Per ``m`` of :data:`PASS1_CASES`: the images and the JAX package's
    pass 1 (``_k1_body`` in the interpreter) of each bf16 mode."""
    out = {}
    for m, (p_, h, w) in PASS1_CASES.items():
        rng = np.random.default_rng(100 + m)
        x0, x1 = (rng.uniform(0.0, 2.0, (p_, h, w)).astype(np.float32)
                  for _ in range(2))
        out[m] = (x0, x1, {mode: jax_cols_fwd_split(x0, x1, 128 * m, mode)
                           for mode in ("split", "bf16")})
    return out


@pytest.mark.parametrize("mode", ["split", "bf16"])
@pytest.mark.parametrize("m", sorted(PASS1_CASES))
def test_pass1_as_the_kernel_computes_it(pass1_jax, mode, m):
    """Pass 1 written out as the kernel computes it against the plain
    version of its mode, against float64 with phase 2's bar, and against
    the JAX package's ``_k1_body`` of the mode."""
    x0, x1, jax_u = pass1_jax[m]
    n = 128 * m
    xs = [torch.as_tensor(v) for v in (x0, x1)]
    u = cols_fwd_as_the_kernel(*xs, n, mode)
    assert u.dtype == torch.complex64 and tuple(u.shape) == (
        x0.shape[0], n, x0.shape[2])
    plain = pf.cols_fwd_plain(*xs, n, mode=mode)
    bar = SPLIT_BAR if mode == "split" else BF16_BAR
    scale = float(plain.abs().max())
    assert_allclose(u.numpy(), plain.numpy(), rtol=0, atol=0.1 * bar * scale)
    u64 = pf.cols_fwd_plain(*(v.double() for v in xs), n, torch.float64)
    anchored = (chip_smoke.split_anchored if mode == "split"
                else chip_smoke.bf16_anchored)
    anchored(f"m = {m}", f"pass 1 {mode}", u, plain, u64)
    j_re, j_im = jax_u[mode]
    scale = max(float(np.abs(j_re).max()), float(np.abs(j_im).max()))
    assert_allclose(u.real.numpy(), j_re, rtol=0, atol=bar * scale)
    assert_allclose(u.imag.numpy(), j_im, rtol=0, atol=bar * scale)


@pytest.mark.parametrize("m", [2, 9])
def test_pass1_resident_table_is_the_dfts_split_planes(m):
    """The bytes pass 1's kernel copies into shared memory, chunk ``c`` of
    32 inputs ``n1`` each (``wg_stage_tables(m)[0, 0]``: the hi plane, then
    the lo plane of ``"split"``, the real part then the imaginary part of
    ``F^T``), read at the addresses its descriptors give (output ``k1``:
    512 bytes a group of eight rows, 16 a row; input: 128 bytes a group of
    eight, 2 each), are the bf16 split planes of ``F = mf[0]`` exactly,
    and ``F`` is the 128-point DFT ``F[n1, k1] = exp(-2 pi i n1 k1 / 128)``
    to float64 rounding."""
    tab = pf.wg_stage_tables(m)[0, 0].view(-1)  # bf16, 4 x 32 KB
    k1 = torch.arange(128)[:, None]
    n1 = torch.arange(128)[None, :]
    c, kc = n1 // 32, n1 % 32
    within = (k1 // 8) * 512 + (kc // 8) * 128 + (k1 % 8) * 16 + (kc % 8) * 2
    dft = pf._stage_tables(m)["mf"][0]  # [n1, k1]
    assert_allclose(dft, np.exp(-2j * np.pi * np.outer(
        np.arange(128), np.arange(128)) / 128), rtol=0, atol=1e-12)
    for part, plane in enumerate((dft.real, dft.imag)):
        ft = torch.as_tensor(plane.T.astype(np.float32))  # [k1][n1]
        for hl, want in enumerate(pf.bf16_split(ft)):
            at = (c * 32768 + hl * 16384 + part * 8192 + within) // 2
            assert torch.equal(tab[at].float(), want)
    # the "bf16" instance copies the hi planes alone: bf16(F)
    assert torch.equal(pf.bf16_split(ft)[0], pf.bf16_round(ft))


class FakeLibrary:
    """A kernel library whose C entries record their calls and succeed."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, entry):
        if entry.endswith("error_string"):
            return lambda code: b"fake"

        def call(*args):
            self.calls.append((self.name, entry, args))
            return 0
        return call


@pytest.mark.parametrize("mode", ["split", "bf16"])
def test_dial_routes_passes_2_and_3_to_the_warpgroup_kernels(monkeypatch,
                                                             mode):
    """On a card, ``"split"`` and ``"bf16"`` launch ``pfft_conv_wg``'s
    entries for the three passes with the mode's products and the tables
    of ``wg_stage_tables`` (pass 1 also the twiddles ``tw``); each
    wrapper counts its launch. The libraries are recorded stand-ins and
    the wrappers' CUDA check is lifted, so that a CPU tensor stands for a
    card's."""
    calls = []
    monkeypatch.setattr(pf, "_library",
                        lambda name: FakeLibrary(name, calls))
    monkeypatch.setattr(pf, "_cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *device: types.SimpleNamespace(cuda_stream=0))
    x = torch.zeros((2, 128, 128))
    planes = [torch.zeros((2, 256, 256)) for _ in range(4)]
    pf.reset_counters()
    pf.pfft_conv_cuda(x, x, *planes, 256, False, mode)
    assert [c[:2] for c in calls] == [
        ("pfft_conv_wg", "pfft_cols_fwd_wg"),
        ("pfft_conv_wg", "pfft_rows_wg"),
        ("pfft_conv_wg", "pfft_cols_inv_wg")]
    tab = pf._device_tables(2, x.device)
    tables = tab["wg"].data_ptr()
    products = pf.TC_PRODUCTS[mode]
    fwd, rows, cols = (c[2] for c in calls)
    assert fwd[2:10] == (2, 128, 128, 2, tables, tab["wf"].data_ptr(),
                         tab["tw"].data_ptr(), rows[0])
    assert fwd[-2:] == (products, 0)
    assert rows[5:11] == (2, 128, 2, 0, tables, tab["wf"].data_ptr())
    assert rows[-2:] == (products, 0)
    assert cols[2:7] == (2, 128, 128, 2, tables)
    assert cols[-2:] == (products, 0)
    tag = "tc" if mode == "split" else "bf16"
    for name in ("cols_fwd", "rows_combine", "cols_inv"):
        for t in ("tc", "bf16"):
            launches = getattr(pf, f"pfft_{name}_{t}_cuda").launches
            assert launches == int(t == tag)


def test_recorded_hessian_action_is_the_jax_packages():
    """``tests/data/pfft_split_hvp_jax.npy`` is the JAX package's
    ``"split"`` Hessian action along ones of
    ``tests/test_torch_pfft_split.py::test_split_second_derivative_matches_jax``
    (``jvp`` of ``grad``, its Pallas kernels in the interpreter), which
    the card test ``test_pfft_split_hessian_action_against_jax`` holds
    the kernels' to; the CPU path's is held to it with that test's bar."""
    x0, x1, n, spectra, c = pfft_hvp_case()
    js = tuple(map(jnp.asarray, spectra))

    def loss(a):
        y0, y1 = jpf.conv_packed_pfft(a, jnp.asarray(x1), *js, n, "split",
                                      True)
        return jnp.mean(c * jnp.sin(y0)) + jnp.mean(y1 * y1)

    x = jnp.asarray(x0)
    hvp = np.asarray(jax.jvp(jax.grad(loss), (x,), (jnp.ones_like(x),))[1])
    recorded = np.load(PFFT_HVP_JAX)
    bar = 2 * SPLIT_BAR * float(np.abs(recorded).max())
    assert_allclose(hvp, recorded, rtol=0, atol=1e-3 * bar)
    got = pfft_hvp_port(torch.device("cpu"))
    assert_allclose(got, recorded, rtol=0, atol=bar)


def test_wrappers_refuse_conjugate_views(monkeypatch):
    """A lazy ``conj()`` keeps the unconjugated values in memory, which a
    kernel would read: the wrappers' checks refuse it (the card's check
    lifted, so that a CPU tensor stands for a card's)."""
    monkeypatch.setattr(pf, "_cuda_device", lambda t, name: t.device)
    v = torch.zeros((1, 256, 128), dtype=torch.complex64)
    with pytest.raises(ValueError, match="conjugate view"):
        pf.pfft_cols_inv_tc_cuda(v.conj(), v, 128)
    with pytest.raises(ValueError, match="conjugate view"):
        pf.pfft_rows_combine_bf16_cuda(v.conj(), *[torch.zeros((1, 256, 256))
                                                  for _ in range(4)])
