"""The CUDA kernels' plain versions (what the wrappers run on a CPU tensor)
against the JAX package's Pallas entry points in interpret mode, on the same
NumPy inputs, plus the guards each wrapper keeps.

Tolerances: decode bit-exact (np.array_equal), every layout; lut-gather
rtol 1e-5 (the same f32 LUT, summed in another order); fused rtol 1e-4
(bf16 operands on both sides, f32 sums in another order). The kernels
themselves run only on the card: chip_smoke.py holds each against these
plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.ops.pallas import (
    decode_conv_kernel_gather as j_decode_conv,
    decode_fc_weight_gather as j_decode_fc,
    pq_fc_fused as j_fused,
    pq_fc_lut_gather as j_lut_gather,
)
from qcnn_tpu_torch.ops import fc as tfc
from qcnn_tpu_torch.ops import lut as tlut
from qcnn_tpu_torch.ops.cuda import (
    KERNELS,
    attention_fused,
    epilogue_fused,
    launches,
    layernorm_fused,
    lrn_fused,
    pq_conv_fused,
    pq_decode,
    pq_fc,
    pq_fc_fused,
    pq_lut_gather,
)
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fc(rng, b, cin, cout, s, k, d):
    x = rng.standard_normal((b, cin)).astype(np.float32)
    p = {
        "codebooks": rng.standard_normal((s, k, d)).astype(np.float32),
        "assignments": rng.integers(0, k, size=(cout, s), dtype=np.uint8),
        "bias": rng.standard_normal(cout).astype(np.float32),
    }
    return x, p


def _rel_err(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1e-6,
                                                 float(np.abs(want).max()))


@pytest.mark.parametrize("cout,s,k,d,cin", [
    (256, 16, 32, 4, 64),
    (250, 15, 32, 4, 58),      # ragged, Cin < S*D
    (64, 8, 128, 4, 32),       # K at the cap
    (1000, 4096, 16, 1, 4096),  # AlexNet fc8, full width
])
def test_decode_fc_matches_pallas(rng, cout, s, k, d, cin):
    cb = rng.standard_normal((s, k, d)).astype(np.float32)
    asmt = rng.integers(0, k, size=(cout, s), dtype=np.uint8)
    want = np.asarray(j_decode_fc(jnp.asarray(cb), jnp.asarray(asmt), cin,
                                  interpret=True))
    got = pq_decode.decode_fc_weight_gather(T(cb), T(asmt), cin)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("layout", ["hwio", "iohw"])
@pytest.mark.parametrize("cout,kh,kw,s,k,d,cg", [
    (96, 11, 11, 1, 128, 8, 3),   # AlexNet conv1 geometry: 3 < D
    (64, 3, 3, 16, 128, 4, 64),
    (40, 1, 1, 9, 16, 4, 36),
])
def test_decode_conv_matches_pallas(rng, layout, cout, kh, kw, s, k, d, cg):
    cb = rng.standard_normal((s, k, d)).astype(np.float32)
    asmt = rng.integers(0, k, size=(cout, kh, kw, s), dtype=np.uint8)
    want = np.asarray(j_decode_conv(jnp.asarray(cb), jnp.asarray(asmt), cg,
                                    layout=layout, interpret=True))
    got = pq_decode.decode_conv_kernel_gather(T(cb), T(asmt), cg,
                                              layout=layout)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_layouts_are_views_of_ohwi(rng):
    """ohwi/hwoi (the port's extra names) are the same values reordered."""
    cb = rng.standard_normal((6, 16, 4)).astype(np.float32)
    asmt = rng.integers(0, 16, size=(8, 3, 3, 6), dtype=np.uint8)
    hwio = pq_decode.decode_conv_kernel_gather(T(cb), T(asmt), 22).numpy()
    ohwi = pq_decode.decode_conv_kernel_gather(T(cb), T(asmt), 22,
                                               layout="ohwi")
    hwoi = pq_decode.decode_conv_kernel_gather(T(cb), T(asmt), 22,
                                               layout="hwoi")
    np.testing.assert_array_equal(ohwi.permute(1, 2, 3, 0).numpy(), hwio)
    np.testing.assert_array_equal(hwoi.permute(0, 1, 3, 2).numpy(), hwio)
    with pytest.raises(ValueError, match="unknown decode layout"):
        pq_decode.decode_conv_kernel_gather(T(cb), T(asmt), 22, layout="x")


def test_decode_bf16_matches_pallas(rng):
    cb = rng.standard_normal((12, 32, 4)).astype(np.float32)
    asmt = rng.integers(0, 32, size=(100, 12), dtype=np.uint8)
    want = j_decode_fc(jnp.asarray(cb, jnp.bfloat16), jnp.asarray(asmt), 48,
                       interpret=True)
    got = pq_decode.decode_fc_weight_gather(T(cb).to(torch.bfloat16),
                                            T(asmt), 48)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("b", [1, 2, 3, 17])
@pytest.mark.parametrize("cin,cout,s,k,d", [
    (64, 256, 16, 32, 4),
    (58, 250, 15, 32, 4),      # Cout not a multiple of 128, Cin < S*D
    (96, 200, 12, 128, 8),     # K at the cap
])
def test_lut_gather_matches_pallas(rng, b, cin, cout, s, k, d):
    x, p = _fc(rng, b, cin, cout, s, k, d)
    want = np.asarray(j_lut_gather(x, p, interpret=True))
    got = pq_lut_gather.pq_fc_lut_gather(T(x), {k_: T(v)
                                               for k_, v in p.items()})
    assert _rel_err(got.numpy(), want) <= 1e-5


def test_lut_gather_alexnet_fc8_full_width(rng):
    x, p = _fc(rng, 1, 4096, 1000, 4096, 16, 1)
    want = np.asarray(j_lut_gather(x, p, interpret=True))
    got = pq_lut_gather.pq_fc_lut_gather(T(x), {k: T(v)
                                               for k, v in p.items()})
    assert _rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("decode", ["gather", "select"])
@pytest.mark.parametrize("b,cin,cout,s,k,d", [
    (1, 64, 256, 16, 32, 4),
    (2, 64, 256, 16, 32, 4),
    (3, 58, 250, 15, 32, 4),    # ragged Cout, Cin < S*D
    (17, 64, 128, 64, 16, 1),
    (3, 96, 200, 12, 16, 8),    # conv-style 8-wide sub-spaces
])
def test_fused_matches_pallas(rng, decode, b, cin, cout, s, k, d):
    """bf16 inputs on both sides (x and codebooks rounded once to bf16)."""
    x, p = _fc(rng, b, cin, cout, s, k, d)
    xb = jnp.asarray(x, jnp.bfloat16)
    cbb = jnp.asarray(p["codebooks"], jnp.bfloat16)
    want = np.asarray(j_fused(xb, dict(p, codebooks=cbb), decode=decode,
                              interpret=True))
    tp = {k_: T(v) for k_, v in p.items()}
    tp["codebooks"] = tp["codebooks"].to(torch.bfloat16)
    got = pq_fc_fused.pq_fc_fused(T(x).to(torch.bfloat16), tp, decode=decode)
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= 1e-4


def test_fused_alexnet_fc8_full_width(rng):
    x, p = _fc(rng, 3, 4096, 1000, 4096, 16, 1)
    want = np.asarray(j_fused(x, p, decode="gather", interpret=True))
    got = pq_fc_fused.pq_fc_fused(T(x), {k: T(v) for k, v in p.items()},
                                  decode="gather")
    assert _rel_err(got.numpy(), want) <= 1e-4


def _wide(rng):
    return _fc(rng, 2, 32, 64, 8, 200, 4)


def test_guards_match_the_jax_entries(rng):
    x, p = _wide(rng)
    tp = {k: T(v) for k, v in p.items()}
    for jfn, tfn in (
        (lambda: j_lut_gather(x, p, interpret=True),
         lambda: pq_lut_gather.pq_fc_lut_gather(T(x), tp)),
        (lambda: j_fused(x, p, interpret=True),
         lambda: pq_fc_fused.pq_fc_fused(T(x), tp)),
        # the JAX Pallas gather's cap stays on the port's 'gdecode' name
        (lambda: j_decode_fc(jnp.asarray(p["codebooks"]),
                             jnp.asarray(p["assignments"]), 32,
                             interpret=True),
         lambda: tfc.pq_fc(T(x), tp, impl="gdecode")),
    ):
        with pytest.raises(ValueError, match="K <= 128"):
            jfn()
        with pytest.raises(ValueError, match="K <= 128"):
            tfn()
    # the pq_decode kernel itself takes any uint8 id (K = 200 here)
    np.testing.assert_array_equal(
        pq_decode.decode_fc_weight_gather(tp["codebooks"], tp["assignments"],
                                          32).numpy(),
        tlut.decode_fc_weight(tp["codebooks"], tp["assignments"], 32).numpy())


def test_fused_coverage_and_decode_guards(rng):
    x, p = _fc(rng, 2, 70, 64, 8, 32, 4)  # S*D = 32 < Cin = 70
    tp = {k: T(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="cover 32 features < Cin=70"):
        j_fused(x, p, interpret=True)
    with pytest.raises(ValueError, match="cover 32 features < Cin=70"):
        pq_fc_fused.pq_fc_fused(T(x), tp)
    x, p = _fc(rng, 2, 32, 64, 8, 32, 4)
    tp = {k: T(v) for k, v in p.items()}
    with pytest.raises(ValueError, match="unknown decode formulation"):
        j_fused(x, p, decode="onehot", interpret=True)
    with pytest.raises(ValueError, match="unknown decode formulation"):
        pq_fc_fused.pq_fc_fused(T(x), tp, decode="onehot")


def test_plain_versions_do_not_count_launches(rng):
    x, p = _fc(rng, 3, 32, 64, 8, 32, 4)
    tp = {k: T(v) for k, v in p.items()}
    before = launches()
    pq_fc_fused.pq_fc_fused(T(x), tp)
    pq_lut_gather.pq_fc_lut_gather(T(x), tp)
    pq_decode.decode_fc_weight_gather(tp["codebooks"], tp["assignments"], 32)
    pq_decode.decode_rows_many([(tp["codebooks"], tp["assignments"], 32)] * 2)
    pq_fc.pq_fc_pallas(T(x), tp)
    lrn_fused.lrn_fused(T(x).reshape(3, 4, 8), size=5, alpha=1e-4, beta=0.75,
                        k=1.0)
    conv_p = {"codebooks": T(rng.standard_normal((16, 16, 4))),
              "assignments": T(rng.integers(0, 16, (8, 3, 3, 16),
                                            dtype=np.uint8)),
              "bias": torch.zeros(8)}
    pq_conv_fused.pq_conv_fused(torch.zeros((1, 5, 5, 64)), conv_p, stride=1,
                                pad=1)
    qkv = T(rng.standard_normal((2, 5, 3 * 64))).to(torch.bfloat16)
    attention_fused.attention_fused(*(t.reshape(2, 5, 1, 64)
                                      for t in qkv.chunk(3, dim=-1)),
                                    scale=0.125)
    epilogue_fused.epilogue(T(x).to(torch.bfloat16), torch.bfloat16,
                            bias=torch.zeros(32), act="gelu")
    layernorm_fused.layernorm_plain(T(x).to(torch.bfloat16),
                                    {"scale": torch.ones(32),
                                     "shift": torch.zeros(32)}, 1e-5)
    assert launches() == before
    assert set(KERNELS) == {"pq_decode", "pq_lut_gather", "pq_fc_fused",
                            "lrn_fused", "pq_conv_fused", "pq_fc",
                            "attention_fused", "epilogue_fused",
                            "window_attention_fused", "layernorm_fused",
                            "pq_fc_fused_general", "pq_conv_fused_general",
                            "pq_lut_gather_general", "lrn_fused_general"}


def test_non_cpu_tensors_never_fall_back(rng):
    """A tensor off the CPU takes the kernel path, which checks for a CUDA
    device and raises: no silent plain version (a 'meta' tensor stands in
    for a device tensor here)."""
    meta = {
        "codebooks": torch.empty((8, 32, 4), device="meta"),
        "assignments": torch.empty((64, 8), dtype=torch.uint8, device="meta"),
        "bias": torch.empty(64, device="meta"),
    }
    x = torch.empty((3, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        pq_fc_fused.pq_fc_fused(x, meta)
    with pytest.raises(ValueError, match="CUDA device"):
        pq_decode.decode_rows(meta["codebooks"], meta["assignments"], 32)
    lut = torch.empty((3, 8, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        pq_lut_gather.lut_gather(lut, meta["assignments"], meta["bias"])
