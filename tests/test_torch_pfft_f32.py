"""K3's three float32 passes as the ``wgmma`` kernels compute them.

Under ``"highest"`` (the ``"f32"`` mode) ``csrc/pfft_conv_wg.cu``'s
``pfft_cols_fwd_f32_kernel``, ``pfft_rows_f32_kernel`` and
``pfft_cols_inv_f32_kernel`` run each stage-B product as the TPU's
``Precision.HIGHEST`` does: both operands split three ways into bf16
parts (``bf16_split3``: hi, mid, lo), the six products whose orders sum
below three summed in float32. The table is each ``k2``'s own
``mf[k2]`` or ``mi[k2]`` (``wg_f32_tables``: three planes, each the real
and the imaginary part of ``M^T``), the data operand ``S_k2`` (passes 1
and 2), ``A . Z`` and ``conj(B2) . Z`` (pass 2) or ``V1 +- conj V2``
(pass 3); passes 2 and 3 sum over ``k2`` into each output block ``a``,
one float32 chain an output.
This file holds that arithmetic, written out in PyTorch, against the
plain version in float64; the tables' layout, read back through the
descriptors' address map; the wrappers' routing; and the pipeline
against the JAX package's ``"f32"`` mode. Tolerances, each with its
reason:

- the tables are the three-way planes exactly, and their sum is the
  float32 entry to 2^-24 of it (the third part's rounding);
- a pass written out as the kernel computes it is held to
  ``chip_smoke.py`` phase 2's bar: at most twice the float32 plain
  version's error against float64, plus 1e-6 of the max-abs; the
  pipeline also within 1e-5 of it (``PFFT_ERR_SHARE``);
- against the JAX package's ``"f32"`` kernels (interpreted): 2e-5 of
  the max-abs, ``tests/test_torch_pfft.py``'s bar (float32 sums in other
  orders on both sides).
"""

import contextlib
import types

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from jolideco_torch.ops import pallas_fft as pf
from jolideco_tpu.ops import pallas_fft as jpf

torch.set_num_threads(1)
# the six products (A part, B part), small first, in the kernels' order
PRODUCTS = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))


def unpack3(m):
    """:func:`pf.wg_f32_tables` back to float32 ``(2, m, split, part, b,
    k1)``: for ``mf`` and ``mi``, per ``k2``, the hi, mid and lo planes of
    the real and imaginary parts of ``M^T``, through the address map of
    the kernels' fragment loads (``[c][split][part][rg][kb][ri][ki]`` a
    chunk of 16 inputs)."""
    t = pf.wg_f32_tables(m).float()
    x = t.reshape(2, m, 8, 3, 2, 16, 2, 8, 8)  # t k2 c s part rg kb ri ki
    return x.permute(0, 1, 3, 4, 5, 7, 2, 6, 8).reshape(2, m, 3, 2, 128,
                                                        128)


def product6(x, tab):
    """``x . M`` for complex ``x`` ``(..., 128)`` as the kernels take it:
    ``tab`` ``(split, part, b, k1)``, the real and imaginary parts of
    ``x`` split three ways, ``Re z = x_re Re M - x_im Im M``, ``Im z =
    x_re Im M + x_im Re M``, the six products summed in float32."""
    xr = pf.bf16_split3(x.real.contiguous())
    xi = pf.bf16_split3(x.imag.contiguous())
    re = im = 0
    for a, b in PRODUCTS:
        are, aim = tab[a, 0].T, tab[a, 1].T
        re = re + xr[b] @ are - xi[b] @ aim
        im = im + xr[b] @ aim + xi[b] @ are
    return torch.complex(re, im)


def cols_fwd_as_the_kernel(x0, x1, n):
    """Pass 1 as ``pfft_cols_fwd_f32_kernel`` computes it: per ``k2``,
    stage A ``S_k2`` in float32, then each column of ``S_k2`` times
    ``mf[k2]``."""
    p_, h, w = x0.shape
    m = n // 128
    t = pf._plain_tables(m, torch.float32, x0.device)
    tab = unpack3(m)
    z = torch.complex(x0, x1).reshape(p_, h // 128, 128, w)
    s = torch.einsum("qk,pqiw->pkwi", t["wf"][:h // 128], z)  # (P, m, W, k1)
    u = torch.stack([product6(s[:, k2], tab[0, k2]) for k2 in range(m)],
                    dim=1)  # (P, m, W, k1)
    return u.transpose(-1, -2).reshape(p_, n, w)


def cols_inv_as_the_kernel(v1, v2, h):
    """Pass 3 as ``pfft_cols_inv_f32_kernel`` computes it: per ``k2``,
    ``P+- = (V1 +- conj V2) mi[k2]`` column by column, then ``y0_a +=
    Re(wi[a][k2] P+)`` and ``y1_a += Im(wi[a][k2] P-)`` in float32, ``k2``
    by ``k2``."""
    p_, n, w = v1.shape
    m, hb = n // 128, h // 128
    t = pf._plain_tables(m, torch.float32, v1.device)
    tab = unpack3(m)
    xp = (v1 + v2.conj()).reshape(p_, m, 128, w).transpose(-1, -2)
    xm = (v1 - v2.conj()).reshape(p_, m, 128, w).transpose(-1, -2)
    y0 = torch.zeros((p_, hb, w, 128))
    y1 = torch.zeros_like(y0)
    for k2 in range(m):
        gp = product6(xp[:, k2], tab[1, k2])[:, None]  # (P, 1, W, b)
        gm = product6(xm[:, k2], tab[1, k2])[:, None]
        w_ = t["wi"][:hb, k2]
        wr, wim = w_.real[:, None, None], w_.imag[:, None, None]
        y0 = y0 + (wr * gp.real - wim * gp.imag)
        y1 = y1 + (wr * gm.imag + wim * gm.real)
    return (y0.transpose(-1, -2).reshape(p_, h, w),
            y1.transpose(-1, -2).reshape(p_, h, w))


def anchored(got, plain32, plain64):
    """``chip_smoke.py`` phase 2's bar of the float32 kernels."""
    err = float((got.to(plain64.dtype) - plain64).abs().max())
    err32 = float((plain32.to(plain64.dtype) - plain64).abs().max())
    scale = float(plain64.abs().max())
    assert err <= 2.0 * err32 + 1e-6 * scale, (err, err32, scale)
    return err / scale


def images(p_, h, w, seed):
    rs = np.random.RandomState(seed)
    return tuple(torch.as_tensor(rs.uniform(0.0, 2.0, (p_, h, w))
                                 .astype(np.float32)) for _ in range(2))


def test_bf16_split3():
    """Three bf16 parts whose sum is x to 2^-24 of it; each part the
    rounding of what the earlier ones leave."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -8 + 2.0 ** -17,
                      1.0 + 2.0 ** -9 + 2.0 ** -20, -3.14159265, 1e-30,
                      0.0])
    hi, mid, lo = pf.bf16_split3(x)
    for part in (hi, mid, lo):
        assert torch.equal(part, part.to(torch.bfloat16).float())
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.equal(mid, (x - hi).to(torch.bfloat16).float())
    assert torch.equal(lo, (x - hi - mid).to(torch.bfloat16).float())
    err = (hi.double() + mid.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -24 * x.double().abs()).all())


@pytest.mark.parametrize("m", [1, 2, 9])
def test_wg_f32_tables_are_the_three_way_planes(m):
    """Each table is the three bf16 planes of ``M^T``'s float32 real and
    imaginary parts, chunk by chunk as a bulk copy lays it; their sum is
    the float32 entry to 2^-24 of the table's max-abs."""
    tab = unpack3(m)
    assert tuple(pf.wg_f32_tables(m).shape) == (2, m, 8, 12288)
    t = pf._stage_tables(m)
    for i, name in enumerate(("mf", "mi")):
        mt = np.swapaxes(t[name], -1, -2)
        for j, plane in enumerate((mt.real, mt.imag)):
            f32 = torch.as_tensor(plane.astype(np.float32))
            for s, part in enumerate(pf.bf16_split3(f32)):
                assert torch.equal(tab[i, :, s, j], part)
            err = float((tab[i, :, :, j].double().sum(1) - f32.double())
                        .abs().max())
            assert err <= 2.0 ** -24 * float(f32.abs().max())


@pytest.mark.parametrize("m,h", [(1, 128), (3, 384), (12, 1280)])
def test_f32_passes_as_the_kernels_compute_them(m, h):
    """Passes 1 and 3 written out as the kernels compute them against the
    float64 plain version, by phase 2's bar; at m = 12, H = 1280 pass 3
    takes ten output blocks (two of the kernel's groups of eight)."""
    n, w = 128 * m, 128
    x0, x1 = images(1, h, w, m)
    u = cols_fwd_as_the_kernel(x0, x1, n)
    anchored(u, pf.cols_fwd_plain(x0, x1, n),
             pf.cols_fwd_plain(x0.double(), x1.double(), n, torch.float64))
    rng = np.random.default_rng(m)
    v = [torch.complex(*(torch.as_tensor(rng.standard_normal((1, n, w))
                                         .astype(np.float32))
                         for _ in range(2))) for _ in range(2)]
    y = cols_inv_as_the_kernel(*v, h)
    y32 = pf.cols_inv_plain(*v, h)
    y64 = pf.cols_inv_plain(*(t.to(torch.complex128) for t in v), h,
                            torch.float64)
    for got, want32, want64 in zip(y, y32, y64):
        anchored(got, want32, want64)


def rows_as_the_kernel(u, a_re, a_im, b2_re, b2_im, conj_spec=False):
    """Pass 2 as ``pfft_rows_f32_kernel`` computes it: per ``k2``, stage
    A ``S_k2`` in float32, ``Z = S_k2 mf[k2]``, the combine ``Y1 = A .
    Z`` and ``Y2 = conj(B2) . Z`` in float32, ``[Y1; Y2] mi[k2]``, then
    ``V1 += wi[a][k2] P1`` and ``V2 += wi[a][k2] P2`` in float32, ``k2``
    by ``k2``, and ``V2`` conjugated at the end."""
    p_, n, w = u.shape
    m, wb = n // 128, w // 128
    t = pf._plain_tables(m, torch.float32, u.device)
    tab = unpack3(m)
    sign = -1.0 if conj_spec else 1.0
    a = torch.complex(a_re, sign * a_im).reshape(p_, n, m, 128)
    b2c = torch.complex(b2_re, -sign * b2_im).reshape(p_, n, m, 128)
    s = torch.einsum("qk,prqi->prki", t["wf"][:wb],
                     u.reshape(p_, n, wb, 128))  # (P, n, m, k1)
    v1 = torch.zeros((p_, n, wb, 128), dtype=torch.complex64)
    v2 = torch.zeros_like(v1)
    for k2 in range(m):
        z = product6(s[:, :, k2], tab[0, k2])
        g1 = product6(a[:, :, k2] * z, tab[1, k2])[:, :, None]
        g2 = product6(b2c[:, :, k2] * z, tab[1, k2])[:, :, None]
        w_ = t["wi"][:wb, k2][:, None]
        v1 = v1 + w_ * g1
        v2 = v2 + w_ * g2
    return v1.reshape(p_, n, w), v2.conj().reshape(p_, n, w)


@pytest.mark.parametrize("conj_spec", [False, True])
@pytest.mark.parametrize("m", [1, 3, 12])
def test_f32_rows_as_the_kernel_computes_it(m, conj_spec):
    """Pass 2 written out as the kernel computes it against the float64
    plain version, by phase 2's bar on ``V1`` and ``V2``, forward and
    adjoint; at m = 12 the kernel takes two rounds of k2."""
    n = 128 * m
    rng = np.random.default_rng(m + 7 * conj_spec)
    u = torch.complex(*(torch.as_tensor(rng.standard_normal((1, n, 128))
                                        .astype(np.float32))
                        for _ in range(2)))
    spectra = [torch.as_tensor(rng.standard_normal((1, n, n))
                               .astype(np.float32)) for _ in range(4)]
    v = rows_as_the_kernel(u, *spectra, conj_spec)
    v32 = pf.rows_combine_plain(u, *spectra, conj_spec)
    v64 = pf.rows_combine_plain(u.to(torch.complex128), *spectra, conj_spec,
                                torch.float64)
    for got, want32, want64 in zip(v, v32, v64):
        anchored(got, want32, want64)


def pipeline(x0, x1, spectra, n, conj_spec):
    """The three passes as the kernels compute them (the ``"f32"``
    pipeline of the card)."""
    u = cols_fwd_as_the_kernel(x0, x1, n)
    v = rows_as_the_kernel(u, *spectra, conj_spec)
    return cols_inv_as_the_kernel(*v, x0.shape[1])


@pytest.mark.parametrize("conj_spec", [False, True])
@pytest.mark.parametrize("p_,h,w,k", [(1, 128, 128, 9), (2, 256, 128, 33)])
def test_f32_pipeline_against_float64_and_jax(p_, h, w, k, conj_spec):
    """The ``"f32"`` pipeline with its passes as the kernels compute
    them, forward and adjoint: within phase 2's bar of the float64 plain
    version and 1e-5 of its max-abs, and within 2e-5 of the JAX
    package's ``"f32"`` kernels (interpreted)."""
    x0, x1 = images(p_, h, w, h + k)
    rs = np.random.RandomState(k)
    n = pf.pfft_size(max(h, w) + k - 1)
    planes = [pf.pfft_pair_spectra(rs.rand(k, k), rs.rand(k, k), (h, w), n)
              for _ in range(p_)]
    spectra = [torch.as_tensor(np.stack([q[j] for q in planes]))
               for j in range(4)]
    y = pipeline(x0, x1, spectra, n, conj_spec)
    y32 = pf.conv_packed_pfft_plain(x0, x1, *spectra, n, conj_spec)
    y64 = pf.conv_packed_pfft_plain(x0.double(), x1.double(), *spectra, n,
                                    conj_spec, torch.float64)
    scale = max(float(t.abs().max()) for t in y64)
    for got, want32, want64 in zip(y, y32, y64):
        anchored(got, want32, want64)
        assert float((got.double() - want64).abs().max()) <= 1e-5 * scale
    js = [jnp.asarray(t.numpy()) for t in spectra]
    if conj_spec:  # the adjoint: both spectra's imaginary parts negated
        js = [js[0], -js[1], js[2], -js[3]]
    jy = jpf.conv_packed_pfft(jnp.asarray(x0.numpy()), jnp.asarray(x1.numpy()),
                              *js, n, "f32", True)
    for got, want in zip(y, jy):
        assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                        atol=2e-5 * scale)


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


def fake_card(monkeypatch):
    """Recorded stand-ins for the kernel libraries, the wrappers' CUDA
    check lifted, so that a CPU tensor stands for a card's; returns the
    list the calls go to."""
    calls = []
    monkeypatch.setattr(pf, "_library",
                        lambda name: FakeLibrary(name, calls))
    monkeypatch.setattr(pf, "_cuda_device", lambda t, name: t.device)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *device: types.SimpleNamespace(cuda_stream=0))
    return calls


def test_highest_routes_passes_1_and_3_to_the_warpgroup_kernels(
        monkeypatch):
    """On a card, ``"f32"`` launches ``pfft_conv_wg``'s float32 entries
    for its three passes with the tables of ``wg_f32_tables``; each
    wrapper counts its launch (:func:`fake_card`)."""
    calls = fake_card(monkeypatch)
    x = torch.zeros((2, 128, 256))
    planes = [torch.zeros((2, 384, 384)) for _ in range(4)]
    pf.reset_counters()
    pf.pfft_conv_cuda(x, x, *planes, 384, True, "f32")
    assert [c[:2] for c in calls] == [
        ("pfft_conv_wg", "pfft_cols_fwd_f32"),
        ("pfft_conv_wg", "pfft_rows_f32"),
        ("pfft_conv_wg", "pfft_cols_inv_f32")]
    tab = pf._device_tables(3, x.device)
    fwd, rows, inv = (c[2] for c in calls)
    assert fwd[2:9] == (2, 128, 256, 3, tab["wg3"].data_ptr(),
                        tab["wf"].data_ptr(), fwd[8])
    assert rows[1:5] == tuple(t.data_ptr() for t in planes)
    assert rows[5:12] == (2, 256, 3, 1, tab["wg3"].data_ptr(),
                          tab["wf"].data_ptr(), tab["wi"].data_ptr())
    assert rows[0] == fwd[8] and rows[12:14] == inv[:2]
    assert inv[2:8] == (2, 128, 256, 3, tab["wg3"].data_ptr(),
                        tab["wi"].data_ptr())
    assert fwd[-1] == rows[-1] == inv[-1] == 0  # the stream
    assert "mi_tc" not in tab
    assert [fn.launches for fn in pf.PASSES["f32"]] == [1, 1, 1]
    assert all(fn.launches == 0 for mode in ("split", "bf16")
               for fn in pf.PASSES[mode])


@pytest.mark.parametrize("mode, built", [
    ("f32", {"wf", "wi", "wg3"}),
    ("split", {"wf", "wi", "tw", "wg"}),
    ("bf16", {"wf", "wi", "tw", "wg"})])
def test_a_mode_builds_only_the_tables_its_kernels_read(monkeypatch, mode,
                                                        built):
    """The device tables are built at first use: a mode's three passes
    (:func:`fake_card`) build the tables their kernels read and no
    other (``"f32"`` no bf16 tables, the bf16 modes not the three-plane
    ones)."""
    fake_card(monkeypatch)
    monkeypatch.setattr(pf, "_DEVICE_TABLES", {})
    x = torch.zeros((2, 128, 256))
    planes = [torch.zeros((2, 384, 384)) for _ in range(4)]
    pf.pfft_conv_cuda(x, x, *planes, 384, False, mode)
    assert set(pf._device_tables(3, x.device)) == built
