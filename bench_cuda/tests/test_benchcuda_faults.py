"""A run with the timed path broken underneath it comes out not correct:
once for each fault an inference cell can have (half of a batch left out,
an answer altered where it is produced) and for faults confined to a tile
(one tile of a batch's rows, one tile of the classifier's classes), in a
cell of each builder; and the same runs unbroken come out correct. The
harness's look for a card is skipped: the runs are on the CPU."""

from __future__ import annotations

import pytest
import torch

from bench_cuda import harness

CELLS = ["tiny-alexnet.offline-b4", "tiny-resnet.offline-b4"]


def half_batch(fwd):
    """Only the second half of each batch is computed; the first half
    repeats its answers."""
    def broken(params, x, **kw):
        n = x.shape[0]
        out = fwd(params, x[n // 2:], **kw)
        return torch.cat([out[: n // 2], out])
    return broken


def altered_answer(fwd):
    """The first answer of every batch has its classes in reverse order."""
    def broken(params, x, **kw):
        out = fwd(params, x, **kw).clone()
        out[0] = out[0].flip(-1)
        return out
    return broken


def row_tile(fwd):
    """The last row of every batch (one tile of rows at a batch of four) is
    computed from its input at half scale: its first class stays where it
    was, the rest of the batch is sound."""
    def broken(params, x, **kw):
        x = x.clone()
        x[-1] = x[-1] * 0.5
        return fwd(params, x, **kw)
    return broken


def class_tile(fwd):
    """One tile of the classifier's classes (16 of them) gets the row's mean
    logit in place of its own, as an output tile left unwritten would."""
    def broken(params, x, **kw):
        out = fwd(params, x, **kw)
        logp = torch.log(out.float().clamp_min(1e-30))
        logp[:, 16:32] = logp.mean(dim=1, keepdim=True)
        return torch.softmax(logp, dim=1).to(out.dtype)
    return broken


FAULTS = [half_batch, altered_answer, row_tile, class_tile]


def patch(monkeypatch, cell: str, fault) -> None:
    """Break the program's forward where the builders' entry points call
    it."""
    from qcnn_tpu_torch.models import network, resnet

    if cell.startswith("tiny-alexnet"):
        monkeypatch.setattr(network, "forward", fault(network.forward))
    else:
        monkeypatch.setattr(resnet, "forward", fault(resnet.forward))


def run(root: str, cell: str) -> dict:
    return harness.run_cell(root, cell, 2**31 + 99, 0.6, False,
                            torch.device("cpu"), harness.now())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    r = run(tiny_root, cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_broken_run_is_not_correct(tiny_root, monkeypatch, cell, fault):
    patch(monkeypatch, cell, fault)
    r = run(tiny_root, cell)
    assert not r["correct"], r["checks"]
    assert list(r)[-1] == "checks"


def best_class_tile(fwd):
    """The tile of 128 of the classifier's classes that holds the best class
    of the batch's first row gets the row's mean logit in place of its
    own, as an output tile left unwritten would."""
    def broken(params, x, **kw):
        out = fwd(params, x, **kw)
        logp = torch.log(out.float().clamp_min(1e-30))
        lo = int(logp[0].argmax()) // 128 * 128
        logp[:, lo:lo + 128] = logp.mean(dim=1, keepdim=True)
        return torch.softmax(logp, dim=1).to(out.dtype)
    return broken


def test_class_tile_fault_at_full_width(tmp_path, monkeypatch):
    """At AlexNet's own widths (1000 classes, 128 a tile). With the
    benchmark's random weights nearly every image has the same few best
    classes, so a class tile moves every answer or none; the tile that
    holds them comes out not correct."""
    import json
    import os

    from conftest import ROOT, write_bench

    name = "alexnet-pq-mem"
    with open(os.path.join(ROOT, "bench_cuda", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    write_bench(str(tmp_path), {name: cfg},
                {"offline-b8": {"load": "offline", "batch": 8,
                                "pool_batches": 2}},
                [(name, "offline-b8")])
    patch(monkeypatch, "tiny-alexnet", best_class_tile)
    r = harness.run_cell(str(tmp_path), f"{name}.offline-b8", 2**31 + 98,
                         0.01, False, torch.device("cpu"), harness.now())
    assert not r["correct"], r["checks"]
