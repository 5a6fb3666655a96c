"""Why passes 2 and 3 of the matrix-DFT convolution round per k2.

Every stage matrix is the 128-point DFT between twiddles (``mf[k2] =
diag(tw[k2]) F``, ``mi[k2] = Fi diag(tb[k2])``), so a kernel could
multiply every k2 block by one ``F`` or ``Fi`` and apply the twiddles in
float32 ("lane" rounding: ``S tw`` and ``R(F)`` rounded), where the JAX
package and this port's plain version round ``S`` and ``R(mf[k2])``
("per-k2"). This script computes, on the CPU in ``"split"`` mode, the
Hessian action of ``tests/test_torch_pfft_split.py``'s
``test_split_second_derivative_matches_jax`` on its seed and three
others, with passes 2 and 3 rounded either way (pass 1 as the port's
plain version), and prints, as shares of that test's bar (2 x 3.1e-5 of
the max-abs of the JAX package's), each rounding's distance from float64
and from the JAX package's, and the JAX package's distance from float64.
Prints one JSON line. Run from the root of a checkout, on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/torch_pfft_lane_rounding.py
"""

import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SEEDS = [(4, 5), (10, 110), (11, 111), (12, 112)]  # (images, weights)


def main():
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import test_torch_pfft_split as t
    from jolideco_torch.ops import pallas_fft as pf
    from jolideco_tpu.ops import pallas_fft as jpf

    torch.set_num_threads(4)
    lane = 128
    i = np.arange(lane)[:, None]
    f = np.exp(-2j * np.pi * i * i.T / lane)
    parts = {name: pf.bf16_split(torch.as_tensor(interleave(mat)))
             for name, mat in (("f", f), ("fi", f.conj()))}

    def tables(m):
        st = pf._plain_tables(m, torch.float32, torch.device("cpu"))
        mf, mi = pf._stage_tables(m)["mf"], pf._stage_tables(m)["mi"]
        tw = torch.as_tensor(mf[:, :, 0].astype(np.complex64))
        tb = torch.as_tensor(mi[:, 0, :].astype(np.complex64))
        return st, tw, tb

    def rows_lane(u, a_re, a_im, b2_re, b2_im, conj_spec=False,
                  dtype=torch.float32, mode="f32"):
        if mode != "split" or dtype != torch.float32:
            return saved[0](u, a_re, a_im, b2_re, b2_im, conj_spec, dtype,
                            mode)
        p_, n, w = u.shape
        m, wb = n // lane, w // lane
        st, tw, tb = tables(m)
        s = torch.einsum("qk,prqi->prki", st["wf"][:wb],
                         u.reshape(p_, n, wb, lane))
        z = pf._tc_product(s * tw, parts["f"])
        sign = -1.0 if conj_spec else 1.0
        a = torch.complex(a_re, sign * a_im).reshape(p_, n, m, lane)
        b2 = torch.complex(b2_re, sign * b2_im).reshape(p_, n, m, lane)
        g1 = pf._tc_product(a * z, parts["fi"]) * tb
        g2 = pf._tc_product(b2.conj() * z, parts["fi"]) * tb
        v1 = torch.einsum("ak,prkj->praj", st["wi"][:wb], g1)
        v2 = torch.einsum("ak,prkj->praj", st["wi"][:wb], g2).conj()
        return v1.reshape(p_, n, w), v2.reshape(p_, n, w).contiguous()

    def cols_lane(v1, v2, h, dtype=torch.float32, mode="f32"):
        if mode != "split" or dtype != torch.float32:
            return saved[1](v1, v2, h, dtype, mode)
        p_, n, w = v1.shape
        m, hb = n // lane, h // lane
        st, _, tb = tables(m)

        def inverse(x):
            g = pf._tc_product(x.reshape(p_, m, lane, w).transpose(-1, -2),
                               parts["fi"]) * tb[:, None]
            return torch.einsum("ak,pkwj->pajw", st["wi"][:hb],
                                g).reshape(p_, h, w)

        v2c = v2.conj()
        return (inverse(v1 + v2c).real.contiguous(),
                inverse(v1 - v2c).imag.contiguous())

    saved = pf.rows_combine_plain, pf.cols_inv_plain
    out = {}
    for seed, cseed in SEEDS:
        x0, x1, n, spectra = t.setup(seed, p_=1)
        c = np.random.default_rng(cseed).random((1, 128, 128)).astype(
            np.float32)
        js = tuple(map(jnp.asarray, spectra))

        def loss_j(a):
            y0, y1 = jpf.conv_packed_pfft(a, jnp.asarray(x1), *js, n,
                                          "split", True)
            return jnp.mean(c * jnp.sin(y0)) + jnp.mean(y1 * y1)

        hj = np.asarray(jax.jvp(jax.grad(loss_j), (jnp.asarray(x0),),
                                (jnp.ones_like(jnp.asarray(x0)),))[1])

        def hvp(dtype, mode):
            x = torch.as_tensor(x0).to(dtype).requires_grad_(True)
            y0, y1 = pf.conv_packed_pfft(
                x, torch.as_tensor(x1).to(dtype),
                *map(torch.as_tensor, spectra), n, mode=mode)
            weights = torch.as_tensor(c).to(dtype)
            loss = (weights * torch.sin(y0)).mean() + (y1 * y1).mean()
            (g,) = torch.autograd.grad(loss, x, create_graph=True)
            (h,) = torch.autograd.grad(g, x, grad_outputs=torch.ones_like(x))
            return h.detach().double().numpy()

        h64 = hvp(torch.float64, "f32")
        per_k2 = hvp(torch.float32, "split")
        pf.rows_combine_plain, pf.cols_inv_plain = rows_lane, cols_lane
        try:
            lane_h = hvp(torch.float32, "split")
        finally:
            pf.rows_combine_plain, pf.cols_inv_plain = saved
        bar = 2 * t.SPLIT_BAR * float(np.abs(hj).max())

        def share(a, b):
            return round(float(np.abs(a - b).max()) / bar, 3)

        out[f"seed {seed}"] = {
            "jax_from_float64": share(hj, h64),
            "per_k2_from_float64": share(per_k2, h64),
            "lane_from_float64": share(lane_h, h64),
            "per_k2_from_jax": share(per_k2, hj),
            "lane_from_jax": share(lane_h, hj)}
    print(json.dumps({"pfft_lane_rounding": out}))


def interleave(mat):
    r = np.empty((2 * mat.shape[0], 2 * mat.shape[1]))
    r[0::2, 0::2] = mat.real
    r[0::2, 1::2] = mat.imag
    r[1::2, 0::2] = -mat.imag
    r[1::2, 1::2] = mat.real
    return r.astype(np.float32)


if __name__ == "__main__":
    main()
