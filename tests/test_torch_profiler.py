"""The per-layer profiler (eval/profiler.py) and the ``profile``
subcommand against the JAX package's, on the CPU.

Both packages' ``profile_layers`` run on the same spec, params (the JAX
package's synthetic ones, carried across by ``params_from_jax``) and
strategies, each prepared by its own package. Rows, kinds, strategies,
output shapes and phase labels must be equal; times are not compared (the
JAX side times on-device loops, here the CPU, with k1=1, k2=2; the port
the host's clock with one repetition). The one label that differs on
purpose: the ``pallas`` FC builds its LUT outside its kernel in both
packages, and the port reports that LUT build where the JAX profiler
counts the layer with its fused kernels.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qcnn_tpu.core as jcore
import qcnn_tpu_torch.core as tcore
from qcnn_tpu import cli as jcli
from qcnn_tpu.eval import profiler as jprof
from qcnn_tpu.models import resnet as jresnet
from qcnn_tpu.models import synth as jsynth
from qcnn_tpu.models import vit as jvit
from qcnn_tpu.models import zoo as jzoo
from qcnn_tpu.models.prepare import prepare_params as jprepare
from qcnn_tpu_torch import cli as tcli
from qcnn_tpu_torch.eval import profiler as tprof
from qcnn_tpu_torch.models import resnet as tresnet
from qcnn_tpu_torch.models import synth as tsynth
from qcnn_tpu_torch.models import vit as tvit
from qcnn_tpu_torch.models import zoo as tzoo
from qcnn_tpu_torch.models.interop import (
    family_params_from_jax,
    params_from_jax,
)
from qcnn_tpu_torch.models.prepare import prepare_params as tprepare

K = dict(k1=1, k2=2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tiny(core):
    """tests/test_profiler.py's net, in either package's spec types."""
    return core.ModelSpec(
        name="tprof", in_height=8, in_width=8, in_channels=8,
        layers=(
            core.ConvSpec(kernel=3, out_channels=16, pad=1),
            core.ReLUSpec(),
            core.PoolSpec(kernel=2, stride=2),
            core.FCSpec(32),
            core.ReLUSpec(),
            core.FCSpec(10),
            core.SoftmaxSpec(),
        ),
    )


def _rows(profiles):
    return [(p.index, p.kind, p.strategy, tuple(p.out_shape), p.phase_label)
            for p in profiles]


def _both(jspec, tspec, params, batch, conv_impl, fc_impl, dtype):
    """(JAX profiles, port profiles) of one spec, params and strategy."""
    jdt, tdt = DTYPES[dtype]
    x = jsynth.random_input(jspec, batch, seed=1)
    pj, cj, fj = jprepare(jspec, params, batch_hint=batch,
                          conv_impl=conv_impl, fc_impl=fc_impl, dtype=jdt)
    want = jprof.profile_layers(jspec, pj, x, conv_impls=cj, fc_impls=fj,
                                compute_dtype=jdt, verbose=False, **K)
    pt, ct, ft = tprepare(tspec, params_from_jax(params, device="cpu"),
                          batch_hint=batch, conv_impl=conv_impl,
                          fc_impl=fc_impl, dtype=tdt, device="cpu")
    assert (ct, ft) == (cj, fj)
    got = tprof.profile_layers(tspec, pt, x, conv_impls=ct, fc_impls=ft,
                               compute_dtype=tdt, reps=1, verbose=False,
                               device="cpu")
    return want, got


def _check_phases(profiles):
    for p in profiles:
        assert p.seconds > 0
        if p.phase1_seconds is not None:
            assert 0.0 <= p.phase1_seconds <= p.seconds
            assert p.phase2_seconds == pytest.approx(
                p.seconds - p.phase1_seconds)


@pytest.mark.parametrize("conv_impl,fc_impl,dtype,labels", [
    ("indecode", "indecode", "bfloat16", {"decode"}),
    ("lut", "gather", "float32", {"lut-build"}),
    ("lut", "fused", "float32", {"lut-build", "fused-est-decode"}),
    ("memory_fused", "fgather", "bfloat16", {"decode", "fused-est-decode"}),
    ("gemm", "onehot", "float32", {"decode", "lut-build"}),
    ("auto", "lutgather", "bfloat16", {"lut-build"}),
])
def test_tiny_spec_rows_and_phases_match_jax(conv_impl, fc_impl, dtype,
                                             labels):
    want, got = _both(_tiny(jcore), _tiny(tcore),
                      jsynth.random_pq_params(_tiny(jcore), seed=0), 4,
                      conv_impl, fc_impl, dtype)
    assert _rows(got) == _rows(want)
    assert {p.phase_label for p in got} - {None} == labels
    _check_phases(got)


def test_pallas_fc_reports_its_lut_build():
    want, got = _both(_tiny(jcore), _tiny(tcore),
                      jsynth.random_pq_params(_tiny(jcore), seed=0), 4,
                      "auto", "pallas", "float32")
    fcs = [i for i, p in enumerate(want) if p.kind == "FC"]
    assert {want[i].phase_label for i in fcs} == {"fused-est-decode"}
    assert {got[i].phase_label for i in fcs} == {"lut-build"}
    strip = [(i, k, s, o) for i, k, s, o, _ in _rows(want)]
    assert [(i, k, s, o) for i, k, s, o, _ in _rows(got)] == strip
    _check_phases(got)


@pytest.fixture(scope="module")
def alexnet_b1():
    """The JAX package's AlexNet profiles at B=1, bf16, auto and memory."""
    params = jsynth.random_pq_params(jzoo.alexnet(), seed=0)
    out = {}
    for impl in ("auto", "memory"):
        out[impl] = _both(jzoo.alexnet(), tzoo.alexnet(), params, 1, impl,
                          impl, "bfloat16")
    return out


@pytest.mark.parametrize("impl", ["auto", "memory"])
def test_full_width_alexnet_rows_match_jax(alexnet_b1, impl):
    want, got = alexnet_b1[impl]
    assert _rows(got) == _rows(want)
    _check_phases(got)
    if impl == "memory":
        labels = {p.strategy: p.phase_label for p in got
                  if p.kind in ("Conv", "FC")}
        assert labels == {"indecode_ohwi": "decode", "lutgather": "lut-build"}


def test_format_table_is_the_jax_table_and_sums_the_rows(alexnet_b1):
    _, got = alexnet_b1["memory"]
    table = tprof.format_table(got)
    assert table == jprof.format_table(got)
    total = sum(p.seconds for p in got)
    assert f"TOTAL {total*1e6:10.1f} us" in table
    for kind in ("Conv", "FC", "Pool"):
        secs = sum(p.seconds for p in got if p.kind == kind)
        assert f"{kind:8s} total {secs*1e6:10.1f} us" in table
    assert "decode=" in table and "lut-build=" in table
    line = tprof.format_table(got, step_decode_seconds=1.5e-4).splitlines()
    assert line[-2].startswith("TOTAL")
    assert line[-1].startswith("step decode      150.0 us")


def test_step_decode_is_one_grouped_launch():
    spec = tzoo.alexnet()
    params = params_from_jax(jsynth.random_pq_params(jzoo.alexnet(), seed=0),
                             device="cpu")
    for impl, decodes in (("memory", True), ("auto", False)):
        prepared, ci, _ = tprepare(spec, params, conv_impl=impl,
                                   fc_impl=impl, device="cpu")
        secs = tprof.profile_step_decode(spec, prepared, ci, reps=1,
                                         device="cpu")
        assert (secs is not None and secs > 0) if decodes else secs is None


def test_fused_decode_estimate_counts_the_plans_row_tiles():
    """fc6 under pq_fc_fused decodes its weight once a tile of batch rows:
    the wgmma kernel's tiles, or the general kernel's 128 rows for a
    shape it alone takes (Cin not a multiple of 64)."""
    from qcnn_tpu_torch.ops.cuda import _plan

    spec = tzoo.alexnet()
    p = params_from_jax(jsynth.random_pq_params(jzoo.alexnet(), seed=0),
                        device="cpu")[15]
    for b in (1, 3, 64, 256, 300, 1024):
        replays, _ = tprof._fused_decode(spec.layers[15], p,
                                         torch.zeros((b, 6, 6, 256)),
                                         "fgather")
        plan = _plan.plan_fc(b, 9216, 4096, 2304, 32, 4)
        assert plan.variant == "wgmma"
        assert replays == -(-b // plan.tile_rows) == plan.grid[0]
    ragged = {"codebooks": p["codebooks"][:, :, :2],
              "assignments": p["assignments"]}      # Cin = 4608 = 72 x 64
    replays, _ = tprof._fused_decode(spec.layers[15], ragged,
                                     torch.zeros((300, 4600)), "fgather")
    assert _plan.plan_fc(300, 4600, 4096, 2304, 32, 2).variant == "general"
    assert replays == 3


def _segment_names(jspec, tspec, fam_j, fam_t, params, x, memory):
    jprep = fam_j.prepare_params(jspec, params, dtype=jnp.bfloat16,
                                 memory=memory)
    want = jprof.profile_segments(
        fam_j.forward_segments(jspec, compute_dtype=jnp.bfloat16), x, jprep,
        **K)
    got = tprof.profile_segments(
        fam_t.forward_segments(tspec, compute_dtype=torch.bfloat16), x,
        family_params_from_jax(jprep, device="cpu"), reps=1, device="cpu")
    assert [n for n, _ in got] == [n for n, _ in want]
    assert all(t > 0 for _, t in got)
    return [n for n, _ in got]


def test_tiny_resnet_segments_match_jax():
    kw = dict(name="basic", stage_depths=(1, 2), stage_channels=(64, 256),
              num_classes=10, in_size=32, bottleneck=False)
    jspec = jresnet.ResNetSpec(**kw)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    names = _segment_names(jspec, tresnet.ResNetSpec(**kw), jresnet, tresnet,
                           tsynth.random_resnet_pq_params(jspec, seed=0), x,
                           memory=True)
    assert names == ["stem+pool", "stage0", "stage1", "head"]


def test_tiny_vit_segments_match_jax():
    jspec = jvit.vit_tiny_test()
    size = jspec.image_size
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(
        np.float32)
    names = _segment_names(jspec, tvit.vit_tiny_test(), jvit, tvit,
                           tsynth.random_vit_pq_params(jspec, seed=0), x,
                           memory=False)
    assert names[0] == "embed" and names[-1] == "head"
    assert len(names) == jspec.depth + 2


_ROW = re.compile(r"^\[\s*(\d+)\] (\S+)\s+(\S+)\s+(\(.*?\))\s+[\d.]+ us")


def test_profile_command_prints_the_jax_rows(alexnet_b1, capsys, tmp_path):
    """`profile --device cpu --model alexnet --batch 1` (bf16, auto: the
    defaults) prints the JAX package's rows, and writes a trace."""
    rc = tcli.main(["profile", "--device", "cpu", "--model", "alexnet",
                    "--batch", "1", "--reference-dir", str(tmp_path / "no"),
                    "--trace", str(tmp_path / "trace")])
    out = capsys.readouterr().out
    assert rc == 0
    rows = [_ROW.match(line).groups() for line in out.splitlines()
            if _ROW.match(line)]
    want, _ = alexnet_b1["auto"]
    assert [(int(i), k, s, o) for i, k, s, o in rows] == [
        (p.index, p.kind, p.strategy, str(tuple(p.out_shape)))
        for p in want]
    assert "TOTAL" in out and "step decode" not in out
    assert (tmp_path / "trace" / "profile_trace.json").stat().st_size > 0


def test_profile_command_runs_a_family(capsys):
    assert tcli.main(["profile", "--device", "cpu", "--model", "resnet18",
                      "--batch", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("resnet18 batch=1 bfloat16 decoded at load "
                      "(synthetic PQ weights)")
    names = [line.split()[0] for line in out[2:]]
    assert names == ["stem+pool", "stage0", "stage1", "stage2", "stage3",
                     "head", "total"]


def test_profile_command_flags_match_jax():
    def flags(parser):
        sub = next(a for a in parser._actions
                   if a.dest == "command").choices["profile"]
        return {a.dest: (a.default, a.choices and list(a.choices))
                for a in sub._actions if a.dest != "help"}

    want = flags(jcli.build_parser())
    got = flags(tcli.build_parser())
    assert got.pop("device") == ("cuda", ["cuda", "cpu"])
    assert got == want


def test_profile_needs_a_card_or_the_cpu_by_name(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model in ("alexnet", "resnet18"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(["profile", "--model", model])
    with pytest.raises(ValueError, match="auto or memory"):
        tcli.main(["profile", "--device", "cpu", "--model", "resnet18",
                   "--conv-impl", "lut"])
    # a trace that cannot be written fails the command
    blocker = tmp_path / "file"
    blocker.write_text("")
    with pytest.raises(OSError):
        tcli.main(["profile", "--device", "cpu", "--model", "alexnet",
                   "--batch", "1", "--reference-dir", str(tmp_path / "no"),
                   "--trace", str(blocker / "trace")])
