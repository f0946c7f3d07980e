"""ViT-L/16 at 384x384 in memory mode, the benchmark's transformer
configuration (``bench_cuda/configs/vitl16-384-pq-mem.json``): the port's
ViT forward against the benchmark's plain float32 reference
(``bench_cuda/reference/vit.py``), the spec and FLOP count of
``bench_cuda/builders/vit_pq.py``, the memory-mode routing at the cell's
rows, and the ``qcnn.*`` spans of a ViT forward.

The CPU tests run a small ViT with several patches (patch 8, 48x48, width
64, 2 blocks, 4 heads, 37 tokens). The tests marked ``card`` run the
cell's own size on the card and skip without one. The file imports no JAX
and nothing from ``tests``, so on a machine with a card and without JAX
they run without the suite's conftest:

    python -m pytest tests/test_torch_vit_l384.py --noconftest -m card -q
"""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from qcnn_tpu_torch.models import common, synth, transformer, vit
from qcnn_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "bench_cuda", "configs", "vitl16-384-pq-mem.json")
SMALL = vit.ViTSpec("ViT-small-test", patch=8, image_size=48, dim=64,
                    depth=2, heads=4, mlp_ratio=4, num_classes=16)
CELL_ROWS = 128 * 577  # the cell's batch times ViT-L/16's tokens at 384


@pytest.fixture(autouse=True, scope="module")
def _thread_share():
    """torch's intra-op threads: the host's cores over the xdist workers,
    restored after the module."""
    before = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, workers)))
    yield
    torch.set_num_threads(before)


def _bench():
    """The benchmark's builder and reference modules."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_cuda import harness
    from bench_cuda.reference import vit as ref

    b = harness.load_module(os.path.join(ROOT, "bench_cuda", "builders",
                                         "vit_pq.py"), "t_vit_pq")
    return b, ref


def _config() -> dict:
    with open(CONFIG) as f:
        return json.load(f)


def _small_config(spec: vit.ViTSpec) -> dict:
    """The benchmark configuration at ``spec``'s sizes."""
    return dict(_config(), model=spec.name,
                input=[spec.image_size, spec.image_size, 3],
                patch_size=spec.patch, hidden_size=spec.dim,
                num_layers=spec.depth, num_heads=spec.heads,
                mlp_dim=spec.mlp_ratio * spec.dim,
                num_classes=spec.num_classes)


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def _image(n, spec, seed=1):
    return torch.randn(n, spec.image_size, spec.image_size, 3,
                       generator=torch.Generator().manual_seed(seed))


def _reference_logits(seed, x):
    _, ref = _bench()
    params = synth.random_vit_pq_params(SMALL, seed=seed)
    return ref.logits(_small_config(SMALL), _as_tensors(params), x).double()


# --- the port against the plain reference ----------------------------------

@pytest.mark.parametrize("memory", [True, False], ids=["memory", "at_load"])
@pytest.mark.parametrize("seed", [0, 7])
def test_float32_forward_is_the_reference(seed, memory):
    """float32 in memory mode and decoded at load: the reference's logits
    to float32 rounding (1e-5 of the largest, as ``test_torch_vit.py``
    holds the port to the JAX package)."""
    params = synth.random_vit_pq_params(SMALL, seed=seed)
    prepared, fwd, _ = common.build_family_forward(
        "vit", SMALL, params, memory=memory, compute_dtype=torch.float32,
        device="cpu")
    x = _image(3, SMALL)
    got = vit.forward(prepared, x, spec=SMALL, compute_dtype=torch.float32,
                      device="cpu").double()
    want = _reference_logits(seed, x)
    assert got.shape == (3, 16)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    probs = fwd(prepared, x).double()
    assert torch.allclose(probs, torch.softmax(want, 1), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_bfloat16_memory_forward_is_near_the_reference(seed):
    """bf16 memory mode against the float32 reference: logits within 3e-2
    of the largest, the first class among the reference's three best.
    bf16 activations carry 8 bits, the attention logits are materialized
    in bf16 (a one-ulp change of q or k moves a softmax weight by up to a
    few percent) and the port rounds after each projection; the JAX
    package's own jitted and eager bf16 forwards differ by 1.16e-2 at a
    like size (``test_torch_vit.py``). Seeds 0-9 here read 8.6e-3 to
    2.4e-2 (seeds 0 and 7: 9.0e-3 and 8.6e-3), and at one of them a near
    tie swaps the first two classes."""
    params = synth.random_vit_pq_params(SMALL, seed=seed)
    prepared, _, _ = common.build_family_forward(
        "vit", SMALL, params, memory=True, compute_dtype=torch.bfloat16,
        device="cpu")
    x = _image(4, SMALL, seed=seed + 2)
    got = vit.forward(prepared, x, spec=SMALL,
                      compute_dtype=torch.bfloat16, device="cpu").double()
    want = _reference_logits(seed, x)
    assert (got - want).abs().max() <= 3e-2 * want.abs().max()
    top3 = want.topk(3, dim=1).indices
    assert (top3 == got.argmax(1, keepdim=True)).any(1).all()


# --- the benchmark's configuration -----------------------------------------

def test_builder_spec_is_vit_l16_at_384():
    b, ref = _bench()
    cfg = _config()
    got, l16 = b.spec(cfg), vit.vit_l16()
    assert (got.patch, got.dim, got.depth, got.heads, got.mlp_ratio,
            got.num_classes) == (l16.patch, l16.dim, l16.depth, l16.heads,
                                 l16.mlp_ratio, l16.num_classes)
    assert (got.image_size, got.num_patches, got.seq_len) == (384, 576, 577)
    assert cfg["reduced"] == [] and cfg["dtype"] == "bfloat16"
    assert ref.sizes(cfg)["tokens"] == got.seq_len


def test_flops_per_image():
    b, _ = _bench()
    assert b.flops_per_image(_config()) == 382_132_600_832


def _meta_pq(cin, cout):
    s = -(-cin // 4)
    meta = torch.device("meta")
    return {"codebooks": torch.empty(s, 32, 4, dtype=torch.bfloat16,
                                     device=meta),
            "assignments": torch.empty(cout, s, dtype=torch.uint8,
                                       device=meta),
            "bias": torch.empty(cout, device=meta)}


def test_every_projection_decodes_in_the_step_at_the_cell_rows():
    """At B=128 and 577 tokens each projection of a block sees 73,856 rows
    (the patch embedding 73,728): every one resolves to 'indecode', so a
    forward runs one grouped decode a block and the embedding's and the
    head's own (26 at depth 24) and no fused kernel."""
    spec = vit.vit_l16()
    d = spec.dim
    blk = {"qkv": _meta_pq(d, 3 * d), "out": _meta_pq(d, d),
           "mlp1": _meta_pq(d, 4 * d), "mlp2": _meta_pq(4 * d, d)}
    x = torch.empty(128, 577, d, dtype=torch.bfloat16,
                    device=torch.device("meta"))
    inputs = transformer.block_inputs(x, blk, torch.bfloat16)
    assert {rows for rows, _, _ in inputs.values()} == {CELL_ROWS}
    routes = transformer.block_routes(inputs, blk)
    assert {name: impl for name, (_, impl, _) in routes.items()} == {
        name: "indecode" for name in blk}
    assert common.fc_memory_impl(128 * 576, _meta_pq(768, d),
                                 torch.bfloat16) == "indecode"
    # the head sees the class token of each image
    assert common.fc_memory_impl(128, _meta_pq(d, 1000),
                                 torch.bfloat16) == "indecode"


# --- spans -------------------------------------------------------------------

def _block_spans(i):
    """The GELU and the two residual adds run in the epilogues of mlp1,
    out and mlp2, under their ``fc`` spans."""
    k = f"blk{i}"
    return {f"qcnn.layernorm:{k}.ln1", f"qcnn.layernorm:{k}.ln2",
            f"qcnn.fc:{k}.qkv", f"qcnn.fc:{k}.out", f"qcnn.fc:{k}.mlp1",
            f"qcnn.fc:{k}.mlp2", f"qcnn.attention:{k}"}


def _span_events(fn):
    """(start, end, name) of the ``qcnn.*`` ranges of one call under the
    profiler, sorted by start, outer first."""
    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    got = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CPU
           and e.name().startswith(spans.PREFIX)]
    return sorted(got, key=lambda e: (e[0], -e[1]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_memory_forward_opens_the_spans_once_a_block(dtype):
    params = synth.random_vit_pq_params(SMALL, seed=3)
    prepared, fwd, _ = common.build_family_forward(
        "vit", SMALL, params, memory=True, compute_dtype=dtype,
        device="cpu")
    x = _image(2, SMALL)
    events = _span_events(lambda: fwd(prepared, x))
    names = [n for _, _, n in events]
    once = {"qcnn.forward", "qcnn.embed", "qcnn.layernorm:final",
            "qcnn.fc:head", "qcnn.softmax:head"}
    for i in range(SMALL.depth):
        once |= _block_spans(i)
    for name in once:
        assert names.count(name) == 1, name
    # one grouped decode a block
    assert names.count("qcnn.decode") == SMALL.depth
    assert set(names) - once - {"qcnn.decode", "qcnn.epilogue"} == set()
    # every range lies in the forward, and the leaves directly under it
    stack = []
    for start, end, n in events:
        while stack and stack[-1][1] <= start:
            stack.pop()
        assert not stack or end <= stack[-1][1], (n, stack[-1][2])
        parent = stack[-1][2] if stack else None
        if n == "qcnn.forward":
            assert parent is None
        elif n == "qcnn.epilogue":
            assert parent.startswith(("qcnn.fc:", "qcnn.embed")), parent
        else:
            assert parent == "qcnn.forward", (n, parent)
        stack.append((start, end, n))


def test_spans_leave_the_output_bits_unchanged():
    params = synth.random_vit_pq_params(SMALL, seed=4)
    prepared, fwd, _ = common.build_family_forward(
        "vit", SMALL, params, memory=True, compute_dtype=torch.bfloat16,
        device="cpu")
    x = _image(2, SMALL)
    plain = fwd(prepared, x)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = fwd(prepared, x)
    assert torch.equal(plain, traced)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


def _cell_forward(card):
    """The cell's timed forward at its own size and a batch of its
    inputs."""
    b, _ = _bench()
    cfg = _config()
    gen = torch.Generator(device=card).manual_seed(2**31 + 5)
    weights = b.make_weights(cfg, gen, card)
    fwd = b.offline_forward(cfg, weights, 128, card)
    x = torch.randn((128, 384, 384, 3), generator=gen, device=card)
    return fwd, x


@pytest.mark.card
def test_cell_forward_launches_on_the_card(card):
    """26 ``pq_decode`` launches a forward (one grouped decode a block, the
    patch embedding's, the head's), one ``attention_fused`` a block, one
    ``epilogue_fused`` for each of the 96 projections of the blocks and for
    the patch embedding, one ``layernorm_fused`` a LayerNorm (49), and no
    fused decode-GEMM."""
    from qcnn_tpu_torch.ops import cuda as cuda_ops

    fwd, x = _cell_forward(card)
    fwd(x)
    torch.cuda.synchronize(card)
    before = dict(cuda_ops.launches())
    probs = fwd(x)
    torch.cuda.synchronize(card)
    after = cuda_ops.launches()
    got = {k: after[k] - before.get(k, 0) for k in after
           if after[k] != before.get(k, 0)}
    assert got == {"pq_decode": 26, "attention_fused": 24,
                   "epilogue_fused": 97, "layernorm_fused": 49}, got
    assert probs.shape == (128, 1000) and torch.isfinite(probs).all()


@pytest.mark.card
def test_every_kernel_of_a_traced_step_lies_in_a_span(card):
    """Each device activity of a traced step, joined to its launch, lies
    under a ``qcnn.*`` span narrower than the forward; only the read-back
    of the probabilities is outside."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from bench_cuda import spans as bench_spans

    fwd, x = _cell_forward(card)
    fwd(x).cpu()
    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd(x).float().cpu()
        torch.cuda.synchronize(card)
    got = bench_spans.reduce(list(prof.profiler.kineto_results.events()))
    print(json.dumps({k: v for k, v in got.items() if k != "names"}))
    assert got["forwards"] == 1
    assert got["unlinked"]["kernels"] == 0
    assert got["outside"]["kernels"] == 1  # the copy to the host
    assert "forward" not in got["kinds"]
    assert {"attention", "layernorm", "fc", "epilogue", "decode", "embed",
            "softmax"} <= set(got["kinds"])
    assert not {"gelu", "residual"} & set(got["kinds"])
    assert got["kinds"]["decode"]["kernels"] == 24
    # one attention_fused launch a block, and no other kernel there
    assert got["kinds"]["attention"]["kernels"] == 24
    # one layernorm_fused launch a LayerNorm, and no other kernel there
    assert got["kinds"]["layernorm"]["kernels"] == 49
