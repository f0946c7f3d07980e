"""Named ranges of the forwards for ``torch.profiler``.

``span(kind, *where)`` marks one boundary of a forward: the step itself
(``qcnn.forward``), its grouped decode (``qcnn.decode``), a layer's product
(``qcnn.conv:<layer>``, ``qcnn.fc:<layer>``), the pass after a product
that casts its dtype, adds its bias and the residual and applies the
activation (``qcnn.epilogue``: ResNet's ReLUs and shortcuts, ViT's GELU
and residual adds), and the plain layers (``qcnn.lrn:<layer>``,
``qcnn.pool:<layer>``, ``qcnn.relu:<layer>``, ``qcnn.softmax:<layer>``).
The ViT forward adds its input cast and embeddings (``qcnn.embed``), its
LayerNorms (``qcnn.layernorm:blk<i>.ln1``, ``.ln2``,
``qcnn.layernorm:final``) and each block's attention from the logits
through the second product and its casts (``qcnn.attention:blk<i>``); its
projections are ``qcnn.fc:blk<i>.qkv``, ``.out``, ``.mlp1``, ``.mlp2`` and
``qcnn.fc:head``. The Swin forward names its blocks ``s<i>b<j>`` (stage,
block) in the same kinds (``qcnn.embed`` holds its patch LayerNorm too),
and adds two: ``qcnn.window:s<i>b<j>.partition`` (the cyclic shift and
the window partition of the block's normalized input) and
``.reverse`` (the head merge, the window reverse and the shift back),
and ``qcnn.merge:s<i>`` (the 2x2 gather of a patch merging and its
LayerNorm; its reduction is ``qcnn.fc:s<i>.reduction``), with
``qcnn.pool:head`` for the mean over the tokens. The MaxViT forward names
its blocks ``s<i>b<j>`` too: its convs are ``qcnn.conv:stem.conv1``,
``stem.conv2`` and ``s<i>b<j>.conv1``, ``.conv3``, ``.proj`` (the
shortcut's 1x1 conv, after ``qcnn.pool:s<i>b0.shortcut``, its 2x2 average
pool); it adds two kinds, ``qcnn.dwconv:s<i>b<j>`` (the depthwise conv
with its 'same' pad and epilogue) and ``qcnn.se:s<i>b<j>`` (the
squeeze-excite: the mean, the two FCs, the gate and the scale); its
partition blocks are ``<block>.block`` and ``<block>.grid`` in the kinds
of a transformer block (``qcnn.layernorm:s<i>b<j>.grid.ln1``,
``qcnn.fc:s<i>b<j>.block.qkv``, ``qcnn.attention:s<i>b<j>.grid``), and its
head ``qcnn.pool:head``, ``qcnn.layernorm:head``, ``qcnn.fc:head.pre``
(with the tanh) and ``qcnn.fc:head``. A profiler that is running records
each as a range of the host's timeline; a kernel belongs to the innermost
range around its launch.

A range is torch's ``RecordFunction`` through ``_RecordFunctionFast``, at
about 2 us a range on the host where ``torch.profiler.record_function``
takes about 14: ResNet-50 opens ~180 ranges a step, which through
``record_function`` made its traced steps bound by the host. It records at
the function scope, not the user scope of ``record_function``, so the
profiler keeps it on the host's timeline only: kineto mirrors user-scope
ranges onto the device's timeline as ``gpu_user_annotation`` events, which
a reduction of device activity would count as device work.

With no profiler running, ``span`` returns one shared context manager that
does nothing: no range, no allocation, no string formatted. The parts of
``where`` are joined with "." only under a profiler, so callers pass them
unformatted. The profiler is the only switch.
"""

from __future__ import annotations

import contextlib

from torch._C._profiler import _RecordFunctionFast as _Range
from torch.autograd import profiler as _profiler

PREFIX = "qcnn."
# a record_function range costs ~10 us a call on the host even with no
# profiler running; this check costs ~0.5 us
NO_SPAN = contextlib.nullcontext()


def span(kind: str, *where):
    """A ``qcnn.<kind>[:<where parts joined by '.'>]`` range while a torch
    profiler runs, else :data:`NO_SPAN`."""
    if not _profiler._is_profiler_enabled:
        return NO_SPAN
    name = PREFIX + kind
    if where:
        name += ":" + ".".join(map(str, where))
    return _Range(name)
