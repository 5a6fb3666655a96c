"""The port's CUDA kernels, compiled for the CPU, against their plain versions.

A CUDA kernel runs only on a card, but its arithmetic is C++. This file
compiles ``jolideco_torch/csrc/*.cu`` with the host's C++ compiler
against a stub of the few CUDA names the kernels use, with every launch
``kernel<<<blocks, threads, ...>>>(args)`` rewritten as a loop that runs
the kernel once per thread, as a block of one thread (``blockDim.x =
1``). A block of one thread reads and writes its own shared memory and
passes its barriers alone, and a warp vote (``__any_sync``) returns the
thread's own vote, which can only skip work whose terms are zero. The
other stubs mean for one thread what they mean on the card: the bit
counts ``__popc`` and ``__ffsll``, and the asynchronous copies of
``cuda_pipeline_primitives.h`` (``__pipeline_memcpy_async`` copies at
once, so committing and waiting have nothing left to do). The
kernels' results do not depend on how threads are grouped, so this runs
their arithmetic, indexing, masking and C entry points (through the
wrappers' own ``ctypes`` signatures) on small inputs. It says nothing of
their speed, their register use or of anything only the card's compiler
does; ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` check them there.

Dynamic shared memory (``extern __shared__``) becomes a static buffer of
the card's 227 KB per block.

The libraries it emulates are :data:`EMULATED`. The others are
:data:`CARD_ONLY`: ``gmm_score_wg`` (K1 and K4 of every mode, K5's MAP
scorers of the bf16 modes, K5's logsumexp, K8 and K9a of every mode) and
``pfft_conv_wg`` (K3's three passes in every mode) are built from
warpgroup tensor-core instructions (``wgmma``, whose operands are spread
over the 128 threads of four warps, bulk copies completing on
``mbarrier``\ s, named barriers and ``setmaxnreg``), so a block of one
thread cannot run them; the card holds them instead
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 2), and on the CPU
their plain versions (``mode="split"``, ``"bf16"``) and their arithmetic
written out in PyTorch (``tests/test_torch_pfft_f32.py`` and
``tests/test_torch_pfft_wg.py``, the matrix-DFT convolution in float32
and in the bf16 modes; ``tests/test_torch_gmm_marg_f32.py`` and
``tests/test_torch_gmm_marg_wg.py``, K1 and K4 of every mode;
``tests/test_torch_marg_probe_wg.py``, K5 lse, K8 and K9a of every
mode) are held against the JAX package.

Tolerances are the card's (``chip_smoke.py`` phase 2): values rtol 1e-5,
argmax identical, the MAP gradients within 1e-4 of their max-abs, the
marginalise kernels within twice the float32 plain version's error
against float64 plus 1e-6 of the max-abs.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from jolideco_torch.ops import gmm_fused as gf
from jolideco_torch.ops import gmm_pallas as gp
from jolideco_torch.priors import GaussianMixtureModel
from jolideco_torch.utils import cuda_build
from jolideco_torch.utils.interop import gmm_from_arrays

torch.set_num_threads(1)
SENTINEL = -1e5

STUB = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(x)
#define __restrict__
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct dim3_ { unsigned x, y, z; };
extern dim3_ threadIdx, blockIdx, blockDim;
template <class T> inline T __ldg(const T* p) { return *p; }
inline bool __any_sync(unsigned, bool vote) { return vote; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffsll(long long v) { return __builtin_ffsll(v); }
inline void __syncthreads() {}
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
"""
MATH_STUB = "#pragma once\n#define CUDART_INF_F __builtin_inff()\n"
PIPELINE_STUB = r"""
#pragma once
#include <cstddef>
#include <cstring>
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t = 0) {
  std::memcpy(dst, src, size);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
"""
LAUNCH = re.compile(r"([\w<>]+?)<<<\s*(.*?),\s*(\w+),.*?>>>\((.*?)\);", re.S)
DYNAMIC_SMEM = re.compile(
    r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];")


def emulated_source(source):
    """The .cu source with each launch as a loop over one-thread blocks."""
    def launch(m):
        return (f"for (int b_ = 0; b_ < (int)({m.group(2)}) * "
                f"(int)({m.group(3)}); ++b_) {{ blockIdx.x = b_; "
                f"{m.group(1)}({m.group(4)}); }}")

    body = LAUNCH.sub(launch, source)
    body = DYNAMIC_SMEM.sub(
        r"alignas(16) static \1 \2[232448 / sizeof(\1)];", body)
    assert "<<<" not in body and "extern __shared__" not in body
    return ("#include \"cuda_runtime.h\"\n"
            "dim3_ threadIdx{0, 0, 0}, blockIdx{0, 0, 0}, "
            "blockDim{1, 1, 1};\n" + body)


# the libraries this file compiles for the CPU, and those it cannot
EMULATED = ("gmm_fused", "gmm_patch")
CARD_ONLY = ("gmm_score_wg", "pfft_conv_wg")


def test_every_library_is_emulated_or_card_only():
    """Each of ``cuda_build.LIBRARIES`` is emulated here or named as
    card-only, with the reason in the module docstring."""
    assert sorted(EMULATED + CARD_ONLY) == sorted(cuda_build.LIBRARIES)
    assert not set(EMULATED) & set(CARD_ONLY)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``load_library`` of ``jolideco_torch.utils.cuda_build`` for the
    emulated builds."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a C++ compiler")
    out = tmp_path_factory.mktemp("emulated")
    (out / "cuda_runtime.h").write_text(STUB)
    (out / "math_constants.h").write_text(MATH_STUB)
    (out / "cuda_pipeline_primitives.h").write_text(PIPELINE_STUB)
    libs = {}
    for name in EMULATED:
        src = out / f"{name}.cpp"
        src.write_text(emulated_source(
            (cuda_build.CSRC_DIR / f"{name}.cu").read_text()))
        lib = out / f"lib{name}.so"
        subprocess.run(
            [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w",
             f"-I{out}", f"-I{cuda_build.CSRC_DIR}", "-o", str(lib),
             str(src)],
            check=True, capture_output=True, timeout=300,
        )
        libs[name] = ctypes.CDLL(str(lib))
    return libs.__getitem__


@pytest.fixture(params=["astro-snr-v1", "random-spd", "random-spd-200"])
def bufs(request):
    """The shipped GMM, whose softmax weights are one-hot, and random SPD
    GMMs whose weights are mixed: K = 13, and K = 200 as in the main path
    (``chip_smoke.py``'s mixed case, where a Hessian action that sums
    all 200 components' terms in one float32 chain misses the bar)."""
    if request.param.startswith("random-spd"):
        k = 200 if request.param.endswith("200") else 13
        rs = np.random.RandomState(1)
        a = rs.randn(k, 64, 64) / 8.0
        gmm = gmm_from_arrays(rs.rand(k, 64),
                              a @ a.transpose(0, 2, 1) + 0.5 * np.eye(64),
                              rs.dirichlet(np.ones(k)), None)
    else:
        gmm = GaussianMixtureModel.from_registry(request.param)
    return gmm.kernel_buffers("cpu")


@pytest.fixture
def libs(emulated, monkeypatch):
    """The wrappers' ctypes libraries, built for the CPU."""
    monkeypatch.setattr(cuda_build, "load_library", emulated)
    return gf._library(), gp._library()


def ptr(t):
    assert t.is_contiguous()
    return t.data_ptr()


def anchored(got, plain32, plain64):
    err = float((got.to(plain64.dtype) - plain64).abs().max())
    err32 = float((plain32.to(plain64.dtype) - plain64).abs().max())
    assert err <= 2.0 * err32 + 1e-6 * float(plain64.abs().max()), (err, err32)


def make_image(shape, seed=0):
    rs = np.random.RandomState(seed)
    img = rs.uniform(0.1, 2.0, size=shape).astype(np.float32)
    img[:8, :10] = 2.0 * SENTINEL
    return torch.as_tensor(img)


@pytest.mark.parametrize("marginalize", [0])
@pytest.mark.parametrize("shape,stride", [((37, 45), 4), ((24, 40), 8)])
def test_fused_kernels_match_plain(libs, bufs, marginalize, shape, stride):
    """K2 on the plain forward's patches and argmax. ``marginalize`` is 0
    alone: the forwards and the marginalise backward of every mode run on
    the warpgroup instructions (``gmm_score_wg``, card-only; their
    arithmetic written out in ``tests/test_torch_gmm_marg_f32.py`` and
    ``tests/test_torch_gmm_marg_wg.py``)."""
    assert not marginalize
    fused, _ = libs
    image = make_image(shape)
    n = gf.fused_patch_count(shape, stride)
    vp, ap, valp, xp = gf.fused_forward_plain(image, bufs, stride, SENTINEL)
    m = valp > 0.5
    assert 0 < int(m.sum()) < n
    dv = torch.as_tensor(np.random.RandomState(2).randn(n),
                         dtype=torch.float32) * valp
    grad = map_backward(fused, xp, ap, valp, dv, bufs, shape, stride)
    want = gf.fused_backward_plain(xp, ap, valp, dv, bufs, shape, stride)
    torch.testing.assert_close(grad, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


def map_backward(fused, xtn, argmax, valid, dv, bufs, shape, stride):
    """K2 through its C entry point: the scratch ``u`` rows, then the
    image gradient, from buffers filled with NaN (every entry written)."""
    h, w = shape
    units = torch.full((xtn.shape[0], 64), float("nan"))
    grad = torch.full(shape, float("nan"))
    assert fused.gmm_fused_bwd(
        ptr(xtn), ptr(argmax), ptr(valid), ptr(dv), ptr(bufs["a_bwd"]),
        ptr(bufs["b_bwd"]), h, w, stride, h // 8, w // 8, ptr(units),
        ptr(grad), None) == 0
    return grad


@pytest.mark.parametrize("shape,stride", [((37, 45), 4), ((24, 40), 2)])
def test_map_backward_is_repeatable(libs, shape, stride):
    """K2 twice on the same inputs gives the same bits: its sums have a
    fixed order (no float atomics), whatever order the patches of a
    component take inside a tile."""
    fused, _ = libs
    bufs = GaussianMixtureModel.from_registry("astro-snr-v1").kernel_buffers(
        "cpu")
    image = make_image(shape, seed=3)
    _, ap, valp, xp = gf.fused_forward_plain(image, bufs, stride, SENTINEL)
    dv = torch.as_tensor(np.random.RandomState(4).randn(len(valp)),
                         dtype=torch.float32)
    first, second = (map_backward(fused, xp, ap, valp, dv, bufs, shape,
                                  stride) for _ in range(2))
    assert bool(torch.isfinite(first).all()) and float(first.abs().max()) > 0
    assert torch.equal(first, second)


@pytest.mark.parametrize("period", [1, 3, 7, 19, 200])
def test_map_backward_any_components_per_tile(libs, period):
    """K2 where the 128 patches of a tile select ``period`` components in
    turn (runs from 128 patches down to one, crossing the half-warps'
    places), at the valid patches of an image, against the plain version
    at the 1e-4 bar."""
    fused, _ = libs
    bufs = GaussianMixtureModel.from_registry("astro-snr-v1").kernel_buffers(
        "cpu")
    shape, stride = (64, 48), 4
    _, _, valid, xtn = gf.fused_forward_plain(make_image(shape, seed=period),
                                              bufs, stride, SENTINEL)
    n = valid.numel()
    argmax = torch.arange(n, dtype=torch.int32) % period
    dv = torch.as_tensor(np.random.RandomState(period).randn(n),
                         dtype=torch.float32)
    grad = map_backward(fused, xtn, argmax, valid, dv, bufs, shape, stride)
    want = gf.fused_backward_plain(xtn, argmax, valid, dv, bufs, shape, stride)
    torch.testing.assert_close(grad, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("n", [1, 33, 130])
def test_patch_kernels_match_plain(libs, bufs, n):
    _, patch = libs
    rs = np.random.RandomState(n)
    x = rs.uniform(-0.5, 0.5, (n, 64)).astype(np.float32)
    x = torch.as_tensor(x - x.mean(axis=1, keepdims=True))
    x[0] = 0.0                        # a masked patch scores as a zero row
    t = torch.as_tensor(rs.randn(n, 64).astype(np.float32))
    k = bufs["rec"].shape[0]
    b64 = {name: v.double() for name, v in bufs.items()}

    values, argmax = torch.empty(n), torch.empty(n, dtype=torch.int32)
    assert patch.gmm_score_rows(ptr(x), n, ptr(bufs["rec"]), k, ptr(values),
                                ptr(argmax), None) == 0
    vp, ap = gp.score_rows_plain(x, bufs)
    torch.testing.assert_close(values, vp, rtol=1e-5, atol=0)
    assert torch.equal(argmax, ap)

    unit, hvp = torch.empty(n, 64), torch.empty(n, 64)
    assert patch.gmm_unit_map(ptr(x), ptr(ap), ptr(bufs["a_full"]),
                              ptr(bufs["b_rows"]), n, ptr(unit), None) == 0
    assert patch.gmm_hvp_map(ptr(t), ptr(ap), ptr(bufs["a_full"]), n,
                             ptr(hvp), None) == 0
    for got, want in ((unit, gp.unit_map_plain(x, ap, bufs)),
                      (hvp, gp.hvp_map_plain(t, ap, bufs))):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))

    # K9b on the plain first stage's weights (K5 lse, K8 and K9a are
    # gmm_score_wg's, card-only)
    lse, _ = gp.score_rows_plain(x, bufs, True)
    x64, t64, lse64 = x.double(), t.double(), lse.double()
    p32, dp32 = gp.hvp_marg_weights_plain(x, t, lse, bufs)
    p64, dp64 = gp.hvp_marg_weights_plain(x64, t64, lse64, b64)
    assert patch.gmm_hvp_marg_mix(
        ptr(x), ptr(t), ptr(p32), ptr(dp32), ptr(bufs["a_full"]),
        ptr(bufs["b_rows"]), n, k, ptr(hvp), None) == 0
    anchored(hvp, gp.hvp_marg_mix_plain(x, t, p32, dp32, bufs),
             gp.hvp_marg_mix_plain(x64, t64, p64, dp64, b64))


@pytest.mark.parametrize("period", [1, 3, 7, 19, 200])
def test_row_map_any_components_per_tile(libs, period):
    """K6 and K7 where the rows of a block select ``period`` components in
    turn (runs from a whole block of 128 rows down to one, crossing the
    half-warps' places) over 300 rows, the last block ragged, against
    the plain versions at the 1e-4 bar; two calls give the same bits."""
    _, patch = libs
    bufs = GaussianMixtureModel.from_registry("astro-snr-v1").kernel_buffers(
        "cpu")
    n = 300
    rs = np.random.RandomState(period)
    x = torch.as_tensor(rs.uniform(-0.5, 0.5, (n, 64)).astype(np.float32))
    t = torch.as_tensor(rs.randn(n, 64).astype(np.float32))
    argmax = torch.arange(n, dtype=torch.int32) % period

    def row_map(name, rows, *b_rows):
        out = torch.full((n, 64), float("nan"))
        assert getattr(patch, name)(ptr(rows), ptr(argmax),
                                    ptr(bufs["a_full"]),
                                    *map(ptr, b_rows), n, ptr(out),
                                    None) == 0
        return out

    for name, rows, b_rows, plain in (
            ("gmm_unit_map", x, (bufs["b_rows"],), gp.unit_map_plain),
            ("gmm_hvp_map", t, (), gp.hvp_map_plain)):
        got = row_map(name, rows, *b_rows)
        want = plain(rows, argmax, bufs)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
        assert torch.equal(got, row_map(name, rows, *b_rows))


def mix_case(case):
    """Rows ``x``, tangents ``t``, weights ``p`` and ``dp`` ``(K, N)`` and
    the GMM's buffers of one K9b case (see
    :func:`test_hvp_marg_mix_cases`)."""
    from jolideco_torch.utils.interop import gmm_from_arrays

    astro = GaussianMixtureModel.from_registry("astro-snr-v1")
    n = {"ragged": 129, "chunks": 300}.get(case, 300)
    rs = np.random.RandomState(len(case))
    x = rs.uniform(-0.5, 0.5, (n, 64)).astype(np.float32)
    x = torch.as_tensor(x - x.mean(axis=1, keepdims=True))
    t = torch.as_tensor(rs.randn(n, 64).astype(np.float32))
    if case in ("one-hot", "mixed", "ragged"):
        # the probe's weights: the float32 plain first stage
        if case == "mixed":
            from test_torch_marginalise import mixed_gmm_arrays

            gmm = gmm_from_arrays(*mixed_gmm_arrays(), None)
        elif case == "ragged":
            # K = 200, every weight of every row nonzero: runs of a whole
            # tile, then a tile of one row
            a = rs.randn(200, 64, 64) / 8.0
            gmm = gmm_from_arrays(rs.rand(200, 64),
                                  a @ a.transpose(0, 2, 1) + 0.5 * np.eye(64),
                                  rs.dirichlet(np.ones(200)), None)
        else:
            gmm = astro
        bufs = gmm.kernel_buffers("cpu")
        lse, _ = gp.score_rows_plain(x, bufs, True)
        p, dp = gp.hvp_marg_weights_plain(x, t, lse, bufs)
        return x, t, p, dp, bufs
    bufs = astro.kernel_buffers("cpu")
    k = bufs["rec"].shape[0]
    rows = np.arange(n)
    if case == "chunks":
        # three to four components a row in three chunks of 64, runs of
        # 14 to 75 rows a tile
        picks = [rows % 7, 64 + rows % 5, 150 + rows % 3,
                 np.where(rows % 4 == 0, 199, 150 + rows % 3)]
    else:
        # one component a row, row index mod the period
        picks = [rows % int(case)]
    p = np.zeros((k, n), np.float32)
    dp = np.zeros((k, n), np.float32)
    for pick in picks:
        p[pick, rows] = rs.uniform(0.1, 1.0, n)
        dp[pick, rows] = rs.randn(n)
    dp[picks[0][::5], rows[::5]] = 0.0    # entries with p alone
    return x, t, torch.as_tensor(p), torch.as_tensor(dp), bufs


@pytest.mark.parametrize("case", ["one-hot", "mixed", "chunks", "ragged",
                                  "1", "3", "7", "19", "200"])
def test_hvp_marg_mix_cases(libs, case):
    """K9b against the plain version in float32 and float64 (the anchored
    bar), twice on the same inputs with the same bits: the probe's
    one-hot weights (``astro-snr-v1``) and mixed weights
    (``mixed_gmm_arrays``, K = 8), rows whose entries span three chunks
    of components (``chunks``), every weight of K = 200 nonzero over 129
    rows (a ragged last tile of one row), and one component a row at row
    index mod 1, 3, 7, 19 and 200 (runs of a whole tile down to one row,
    the tile's rows in 128 components), over 300 rows."""
    _, patch = libs
    x, t, p, dp, bufs = mix_case(case)
    n, k = x.shape[0], p.shape[0]
    b64 = {name: v.double() for name, v in bufs.items()}

    def mix():
        out = torch.full((n, 64), float("nan"))
        assert patch.gmm_hvp_marg_mix(
            ptr(x), ptr(t), ptr(p), ptr(dp), ptr(bufs["a_full"]),
            ptr(bufs["b_rows"]), n, k, ptr(out), None) == 0
        return out

    got = mix()
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0
    anchored(got, gp.hvp_marg_mix_plain(x, t, p, dp, bufs),
             gp.hvp_marg_mix_plain(x.double(), t.double(), p.double(),
                                   dp.double(), b64))
    assert torch.equal(got, mix())
