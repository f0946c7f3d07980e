"""The ViT family (models/vit.py, models/synth.random_vit_pq_params, the
"vit" wiring of models/common.build_family_forward and ops.fc's grouped
decode) against the JAX package on the same NumPy PQ params.

The JAX side prepares the params and runs ``qcnn_tpu.models.vit.forward``
eagerly (its Pallas fused kernel in interpret mode); the port runs both the
JAX-prepared params, carried across by ``family_params_from_jax``, and its
own ``build_family_forward`` on the raw params.

Tolerances and what was measured on the CPU with these seeds:
- float32: logits 1e-5 of their largest magnitude, probabilities 1e-6
  (measured 5.6e-7 on vit_tiny_test, 1.5e-6 on ViT-B/16, 1.4e-6 on the
  ViT-L-width block; probabilities 2.5e-7);
- bfloat16: logits 2e-2 of their largest magnitude, probabilities 1e-2,
  top-1 equal. ResNet's limits (1e-2 and 2e-3) are below the JAX
  package's own spread here: its jitted and eager forwards of the same
  params differ by 1.16e-2 in logits and 3.6e-3 in probabilities
  (vit_tiny_test), 1.15e-2 and 1.9e-4 (ViT-B/16), 7.9e-3 and 4.6e-3 (the
  ViT-L-width block). The attention logits are bf16, so a one-ulp
  difference in q or k moves a softmax weight by up to a few percent.
  Measured: logits 8.9e-3 on vit_tiny_test (all of it from GELU: the JAX
  package's bf16 erfc GELU rounds after each op, F.gelu once), 1.0e-2 on
  ViT-B/16, 3.0e-3 on the ViT-L-width block, 4.1e-3 with OPQ perms;
  probabilities 1.9e-3 at most;
- int8 (dynamic amax, bf16 activations): logits 1e-1 of their largest
  magnitude, probabilities 2e-2, top-1 equal; the JAX package's jitted and
  eager int8 forwards differ by 4.9e-2 and 8.4e-3 (vit_tiny_test).
  Measured 3.5e-2 and 3.4e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcnn_tpu.models import vit as jvit
from qcnn_tpu_torch.models import common as tcommon
from qcnn_tpu_torch.models import synth
from qcnn_tpu_torch.models import transformer
from qcnn_tpu_torch.models import vit as tvit
from qcnn_tpu_torch.models.interop import family_params_from_jax
from qcnn_tpu_torch.ops import conv as conv_ops
from qcnn_tpu_torch.ops.cuda import pq_decode
from tests.torch_threads import torch_thread_cap as _torch_threads  # noqa: F401, autouse

TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 1e-2),
       "int8": (1e-1, 2e-2)}
# one block at ViT-L's width: its MLP GEMMs (1024 -> 4096 -> 1024) route
# to the fused kernel at 5 tokens a row
L_BLOCK = dict(name="ViT-L-block", patch=16, image_size=32, dim=1024,
               depth=1, heads=16, mlp_ratio=4, num_classes=10)


def _specs(name):
    if name == "l_block":
        return jvit.ViTSpec(**L_BLOCK), tvit.ViTSpec(**L_BLOCK)
    return getattr(jvit, name)(), getattr(tvit, name)()


def _compare(jspec, tspec, params, batch, memory, dtype):
    """JAX forward against the port on the carried params and through
    build_family_forward; returns the port's prepared params."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    act_j = jnp.bfloat16 if dtype == "int8" else jdt
    x = np.random.default_rng(1).standard_normal(
        (batch, tspec.image_size, tspec.image_size, 3)).astype(np.float32)
    pj = jvit.prepare_params(jspec, params, dtype=jdt, memory=memory)
    want = np.asarray(jvit.forward(pj, jnp.asarray(x), spec=jspec,
                                   compute_dtype=act_j), np.float32)
    prepared, fwd, act = tcommon.build_family_forward(
        "vit", tspec, params, memory=memory, compute_dtype=tdt,
        device="cpu")
    assert act == (torch.bfloat16 if dtype == "int8" else tdt)
    carried = tvit.forward(family_params_from_jax(pj, device="cpu"), x,
                           spec=tspec, compute_dtype=act, device="cpu")
    own = tvit.forward(prepared, x, spec=tspec, compute_dtype=act,
                       device="cpu")
    probs = fwd(prepared, x)
    logit_tol, prob_tol = TOL[dtype]
    scale = float(np.abs(want).max())
    for got in (carried, own):
        assert got.shape == (batch, tspec.num_classes)
        assert float(np.abs(got.numpy() - want).max()) <= logit_tol * scale
    assert probs.dtype == torch.float32 and torch.isfinite(probs).all()
    p_want = np.asarray(jax.nn.softmax(want))
    assert float(np.abs(probs.numpy() - p_want).max()) <= prob_tol
    np.testing.assert_array_equal(probs.numpy().argmax(1), want.argmax(1))
    torch.testing.assert_close(probs, torch.softmax(own, -1), rtol=0,
                               atol=0)
    return prepared


@pytest.mark.parametrize("memory,dtype", [(False, "float32"),
                                          (True, "bfloat16"),
                                          (False, "int8"), (True, "int8")])
def test_tiny_vit_matches_jax(memory, dtype):
    jspec, tspec = _specs("vit_tiny_test")
    params = synth.random_vit_pq_params(tspec, seed=0)
    prepared = _compare(jspec, tspec, params, 3, memory, dtype)
    blk = prepared["blk0"]
    if memory:  # bf16 codebooks under int8 too
        assert blk["qkv"]["codebooks"].dtype == torch.bfloat16
        assert blk["qkv"]["assignments"].dtype == torch.uint8
    elif dtype == "int8":
        assert blk["mlp2"]["weight_q"].dtype == torch.int8
        assert blk["ln1"]["scale"].dtype == torch.float32
    else:
        assert blk["mlp1"]["weight"].shape == (64, 256)
    assert prepared["pos_embed"].dtype == torch.float32


@pytest.mark.parametrize("memory,dtype", [(False, "float32"),
                                          (True, "bfloat16")])
def test_full_width_vit_b16_matches_jax(memory, dtype):
    """Full-width ViT-B/16 (224x224, 1000 classes) at B=1."""
    jspec, tspec = _specs("vit_b16")
    params = synth.random_vit_pq_params(tspec, seed=0)
    _compare(jspec, tspec, params, 1, memory, dtype)


def _routes(x, blk, od) -> dict:
    """The block's routes decided from its input x."""
    return transformer.block_routes(transformer.block_inputs(x, blk, od), blk)


def test_vit_l_width_block_routes_mlp_to_the_fused_kernel():
    """At ViT-L's width the MLP GEMMs go to 'fgather' (pq_fc_fused) while
    fewer than 1025 rows reach them, qkv and out to the grouped decode;
    the block matches the JAX package's, whose fused kernel runs in
    interpret mode."""
    jspec, tspec = _specs("l_block")
    params = synth.random_vit_pq_params(tspec, seed=0)
    prepared = tvit.prepare_params(tspec, params, dtype=torch.bfloat16,
                                   memory=True, device="cpu")
    blk = prepared["blk0"]
    x = torch.zeros((3, tspec.seq_len, 1024), dtype=torch.bfloat16)
    routes = _routes(x, blk, torch.bfloat16)
    assert {k: impl for k, (_, impl, _) in routes.items()} == {
        "qkv": "indecode", "out": "indecode", "mlp1": "fgather",
        "mlp2": "fgather"}
    # rows, not images, decide: 6 x 197 rows of ViT-L/16 fall back
    big = torch.zeros((6, 197, 1024), dtype=torch.bfloat16)
    routes = _routes(big, blk, torch.bfloat16)
    assert {impl for _, impl, _ in routes.values()} == {"indecode"}
    five = torch.zeros((5, 197, 1024), dtype=torch.bfloat16)
    routes = _routes(five, blk, torch.bfloat16)
    assert routes["mlp1"][1] == routes["mlp2"][1] == "fgather"
    # float32 activations keep the exact in-step decode
    routes = _routes(x.float(), blk, None)
    assert {impl for _, impl, _ in routes.values()} == {"indecode"}
    _compare(jspec, tspec, params, 3, True, "bfloat16")
    _compare(jspec, tspec, params, 1, False, "float32")


def test_opq_perm_is_folded_at_load_and_applied_in_step(rng):
    jspec, tspec = _specs("vit_tiny_test")
    params = synth.random_vit_pq_params(tspec, seed=0)
    params["blk1"]["mlp2"]["perm"] = rng.permutation(256).astype(np.int32)
    params["blk0"]["qkv"]["perm"] = rng.permutation(64).astype(np.int32)
    params["head"]["perm"] = rng.permutation(64).astype(np.int32)
    _compare(jspec, tspec, params, 2, False, "float32")
    prepared = _compare(jspec, tspec, params, 2, True, "bfloat16")
    assert prepared["blk1"]["mlp2"]["perm"].dtype == torch.int64
    # memory mode applies the perm: the same bits as decode at load in f32
    x = np.random.default_rng(3).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    outs = [tvit.forward(tvit.prepare_params(
        tspec, params, dtype=torch.float32, memory=memory, device="cpu"),
        x, spec=tspec, device="cpu") for memory in (False, True)]
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_pad", [1, 111, 239])
def test_masked_attention_padding(n_pad):
    """Padded keys change nothing but the order of float32 sums (the JAX
    package's own test holds 1e-6); with bf16 logits the port matches the
    JAX package's attention."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((2, 17, 4, 8)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ref = tvit._masked_attention(tq, tk, tv, 0)
    got = tvit._masked_attention(tq, tk, tv, n_pad)
    assert got.dtype == torch.float32 and got.shape == (2, 17, 4, 8)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    want = np.asarray(jvit._masked_attention(*map(jnp.asarray, (q, k, v)),
                                             n_pad))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # bf16 q/k/v, bf16 logits: the JAX package's order of roundings
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in jb]
    want = np.asarray(jvit._masked_attention(*jb, n_pad, jnp.bfloat16))
    got = tvit._masked_attention(*tb, n_pad, torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2, atol=1e-2)
    unpadded = tvit._masked_attention(*tb, 0, torch.bfloat16)
    torch.testing.assert_close(got, unpadded, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("hd", [16, 64, 32, 48])
def test_attention_logits_keep_the_order_of_roundings(hd):
    """bf16 logits are float32 sums divided by sqrt(hd) and rounded once,
    for any head width (a power-of-two 1/sqrt(hd) takes the bf16 matmul
    and an exact scale, any other hd the float32 matmul)."""
    rng = np.random.default_rng(hd)
    q = torch.from_numpy(rng.standard_normal((2, 3, 9, hd)).astype(
        np.float32)).bfloat16()
    k = torch.from_numpy(rng.standard_normal((2, 3, 9, hd)).astype(
        np.float32)).bfloat16()
    got = tvit._logits(q, k.transpose(-1, -2), hd, torch.bfloat16)
    exact = (q.double() @ k.double().transpose(-1, -2)).float()
    want = (exact / np.float32(np.sqrt(hd))).bfloat16()
    assert got.dtype == torch.bfloat16
    assert (got != want).float().mean().item() <= 0.01
    torch.testing.assert_close(got.float(), want.float(), rtol=8e-3,
                               atol=1e-6)
    f32 = tvit._logits(q.float(), k.float().transpose(-1, -2), hd,
                       torch.float32)
    torch.testing.assert_close(f32, exact / np.sqrt(hd), rtol=1e-6,
                               atol=1e-6)


def test_forward_segments_compose_to_forward():
    tspec = tvit.vit_tiny_test()
    params = synth.random_vit_pq_params(tspec, seed=0)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    for memory, dtype in ((False, torch.float32), (True, torch.bfloat16)):
        prepared = tvit.prepare_params(tspec, params, dtype=dtype,
                                       memory=memory, device="cpu")
        segs = tvit.forward_segments(tspec, compute_dtype=dtype)
        assert [n for n, _ in segs] == ["embed", "blk0", "blk1", "head"]
        y = x
        for _, fn in segs:
            y = fn(y, prepared)
        want = tvit.forward(prepared, x, spec=tspec, compute_dtype=dtype,
                            device="cpu")
        torch.testing.assert_close(y, want, rtol=0, atol=0)


def _assert_same_tree(ours, theirs):
    if isinstance(theirs, dict):
        assert ours.keys() == theirs.keys()
        for key in theirs:
            _assert_same_tree(ours[key], theirs[key])
    else:
        np.testing.assert_array_equal(ours, theirs)
        assert np.asarray(ours).dtype == np.asarray(theirs).dtype


@pytest.mark.parametrize("model", ["vit_b16", "vit_s16", "vit_l16",
                                   "vit_tiny_test"])
def test_copies_match_the_jax_package(model):
    jspec, tspec = _specs(model)
    assert tspec.__dict__ == jspec.__dict__
    assert (tspec.num_patches, tspec.seq_len) == (jspec.num_patches,
                                                  jspec.seq_len)
    assert tvit._gemm_cin_map(tspec) == jvit._gemm_cin_map(jspec)
    assert tvit.VITS.keys() == jvit.VITS.keys()
    if model == "vit_tiny_test":
        _assert_same_tree(tvit.init_dense_params(tspec, seed=3),
                          jvit.init_dense_params(jspec, seed=3))


def test_synth_geometry_matches_quantize_params():
    """The layout and codebook geometry of vit.quantize_params at its
    defaults: every GEMM D=4, K=32, S = ceil(Cin/4); LayerNorms,
    cls_token and pos_embed dense, of the dense params' shapes."""
    jspec, tspec = _specs("vit_tiny_test")
    dense = jvit.init_dense_params(jspec, seed=0)
    quantized = jvit.quantize_params(jspec, dense)
    ours = synth.random_vit_pq_params(tspec, seed=0)

    def same_geometry(a, b):
        if isinstance(b, dict):
            assert a.keys() == b.keys()
            for key in b:
                same_geometry(a[key], b[key])
        else:
            assert np.shape(a) == np.shape(b)
            assert np.asarray(a).dtype == np.asarray(b).dtype

    same_geometry(ours, quantized)
    spec = tvit.vit_b16()
    params = synth.random_vit_pq_params(spec, seed=0)
    assert params.keys() == jvit.init_dense_params(jvit.vit_b16()).keys()
    cins = tvit._gemm_cin_map(spec)
    for path, cin in cins.items():
        node = params
        for part in path.split("."):
            node = node[part]
        assert node["codebooks"].shape == (-(-cin // 4), 32, 4)
        assert node["assignments"].shape[1] == -(-cin // 4)
        assert node["assignments"].dtype == np.uint8
        # decoded weights have init_dense_params' scale
        assert abs(node["codebooks"].std() * np.sqrt(cin) - 1) < .2
    assert params["pos_embed"].shape == (1, 197, 768)
    np.testing.assert_array_equal(
        synth.random_vit_pq_params(spec, seed=0)["blk3"]["mlp2"][
            "assignments"], params["blk3"]["mlp2"]["assignments"])


def test_block_decodes_in_one_grouped_launch(monkeypatch):
    """Memory mode decodes a block's 'indecode' projections with one
    decode_rows_many call, whose rows equal per-projection decodes; the
    embedding and the head decode on their own."""
    tspec = tvit.vit_tiny_test()
    params = synth.random_vit_pq_params(tspec, seed=0)
    prepared = tvit.prepare_params(tspec, params, dtype=torch.bfloat16,
                                   memory=True, device="cpu")
    calls = []
    many = pq_decode.decode_rows_many

    def spy(items):
        items = list(items)
        calls.append([tuple(ids.shape) for _, ids, _ in items])
        return many(items)

    monkeypatch.setattr(pq_decode, "decode_rows_many", spy)
    x = np.random.default_rng(4).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)
    tvit.forward(prepared, x, spec=tspec, compute_dtype=torch.bfloat16,
                 device="cpu")
    grouped = [(192, 16), (64, 16), (256, 16), (64, 64)]
    assert calls == [[(64, 48)], grouped, grouped, [(10, 16)]]
    blk = prepared["blk1"]
    routes = {name: (blk[name], "indecode", blk[name]["codebooks"].shape[0]
                     * 4) for name in ("qkv", "out", "mlp1", "mlp2")}
    rows = conv_ops.instep_decodes(routes)
    for name, (p, _, cin) in routes.items():
        torch.testing.assert_close(
            rows[name], many([(p["codebooks"], p["assignments"], cin)])[0],
            rtol=0, atol=0)
        assert rows[name].shape == (p["assignments"].shape[0], cin)


def test_prepare_rejects_int8_prepared_params_and_other_dtypes():
    tspec = tvit.vit_tiny_test()
    params = synth.random_vit_pq_params(tspec, seed=0)
    prepared = tvit.prepare_params(tspec, params, dtype=torch.int8,
                                   device="cpu")
    with pytest.raises(ValueError, match="prepared int8 already"):
        tvit.prepare_params(tspec, prepared, device="cpu")
    with pytest.raises(ValueError, match="unsupported dtype"):
        tvit.prepare_params(tspec, params, dtype=torch.float16,
                            device="cpu")
    # the quantizer is ported: without a card it raises rather than run on
    # the CPU unasked, and on the CPU it quantizes every projection GEMM
    dense = tvit.init_dense_params(tspec)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tvit.quantize_params(tspec, dense)
    q = tvit.quantize_params(tspec, dense, num_codewords=8, device="cpu")
    assert q["blk0"]["qkv"]["assignments"].dtype == np.uint8
    assert "kernel" not in q["blk0"]["ln1"] and "scale" in q["blk0"]["ln1"]


@pytest.mark.parametrize("model,images,decodes,fused", [
    ("vit_b16", 32, 14, 0), ("vit_b16", 1, 14, 0),
    ("vit_l16", 1, 26, 48), ("vit_l16", 5, 26, 48), ("vit_l16", 6, 26, 0)])
def test_full_width_memory_launches(model, images, decodes, fused):
    """The kernel launches of one full-width bf16 memory-mode forward, from
    the routes of its shapes (the counts chip_smoke.py holds the card to):
    one pq_decode for the patch embedding, one per block (its 'indecode'
    projections grouped), one for the head; pq_fc_fused for every
    'fgather' projection."""
    spec = getattr(tvit, model)()
    prepared = tvit.prepare_params(spec, synth.random_vit_pq_params(spec),
                                   dtype=torch.bfloat16, memory=True,
                                   device="cpu")
    bf = torch.bfloat16
    rows = images * spec.num_patches
    impls = [tcommon.fc_memory_impl(rows, prepared["patch_embed"], bf),
             tcommon.fc_memory_impl(images, prepared["head"], bf)]
    n_decode = impls.count("indecode")
    x = torch.empty((images, spec.seq_len, spec.dim), dtype=bf,
                    device="meta")
    for i in range(spec.depth):
        blk = prepared[f"blk{i}"]
        routes = _routes(x, blk, bf)
        block = [impl for _, impl, _ in routes.values()]
        n_decode += "indecode" in block
        impls += block
    assert set(impls) <= {"indecode", "fgather"}
    assert (n_decode, impls.count("fgather")) == (decodes, fused)
