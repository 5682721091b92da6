"""The serving forward as replays of CUDA graphs.

:func:`forward` runs ``model(images)``. Where the images are on CUDA,
inference mode is on, the model is in eval mode and :func:`capturable`
(built from the parts whose segments are known to capture: ``PSGTr`` on a
ResNet or Swin backbone with ``PairNetHead``, its
``MSDeformAttnPixelDecoder`` and ``Mask2FormerDecoder``), the forward's
segments run as replays of CUDA graphs; otherwise it runs eagerly.

Segments. The first graphed forward of a model makes segments of these, on
the model's own instances (:func:`_cut`): the backbone's ``forward``, the
pixel decoder's, the head's ``positions``, in ``Mask2FormerDecoder`` its
``_start`` (with layer 0's mask), each later layer's ``_mask``, each
``DecoderLayer``'s ``forward`` and its ``_head``, and the head's ``pair``.
The modules are still entered through ``Module.__call__``, so the pre-hooks
and forward hooks of the model, the backbone, the head, the pixel decoder,
the transformer decoder and each of its layers run on every request with
that request's tensors. A hook on a module inside a segment runs only while
the segment is captured. Outside a graphed forward a segment calls its
function.

Capture. The graphs of one key (the images' shape, dtype and device, the
MSDA implementation and the flash-attention switch of every module that has
one) are captured on the key's first forward, in order, on one side stream,
into one memory pool. Each segment first runs once eagerly on that stream
(lazy set-up, cuBLAS's and cuDNN's choices, the int4 quantize's workspace),
is then captured, and is replayed at once so that what follows reads its
results. A segment's outputs stay referenced, so later captures allocate
around them and the next segment reads them where they lie: a replay copies
only an input that is not where the capture read it, which is the
backbone's input, the images. A graph keeps alive every tensor that its
operations read and did not make (:class:`_Reads`), such as the device
tensors that caches hold.

The ops count their launches where they launch, in their wrappers: a
capturing forward runs each segment's Python twice (warm-up and capture), a
replay none. The outputs that :func:`forward` returns are copies: the next
replay overwrites the graphs' own. At most ``KEYS`` keys are kept a model,
the least recently used dropped. A parameter or buffer that moved (``.to``,
``.data`` reassigned) drops the model's graphs; a module or parameter
replaced by another object after the first graphed forward is not seen.
One graphed forward runs at a time a model.

Counters (``tracing.snapshot()``): ``serve_graph.captures``, ``.replays``
and ``.eager``, the forwards that captured, replayed, or ran without
graphs. The span ``pairnet.serve_graph.capture`` covers a capturing
forward.
"""

from __future__ import annotations

import functools
import threading
import weakref
from collections import OrderedDict
from typing import NamedTuple

import torch
from torch.overrides import TorchFunctionMode

from pairnet_torch.utils import tracing

KEYS = 8  # keys whose graphs a model keeps

_local = threading.local()  # .run: the graphed forward running on this thread
_models: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()  # model -> _ModelGraphs | None
_streams: dict[int, torch.cuda.Stream] = {}  # device index -> the capture stream


def segment(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; in a graphed forward, the replay of its
    graph."""
    run = getattr(_local, "run", None)
    if run is None or run.inside:
        return fn(*args, **kwargs)
    return run.segment(name, fn, args, kwargs)


def capturable(model) -> bool:
    """Whether ``model``'s type and its parts' types are those whose
    segments capture: ``PSGTr`` without a neck, a ``ResNet``, ``ResNeXt``
    or ``SwinTransformer`` backbone, a ``PairNetHead`` with its
    ``MSDeformAttnPixelDecoder`` and ``Mask2FormerDecoder``, and no MSDA
    split over ranks (its all-gather)."""
    from pairnet_torch.models.backbones.resnet import ResNet, ResNeXt
    from pairnet_torch.models.backbones.swin import SwinTransformer
    from pairnet_torch.models.decoders.mask2former_decoder import Mask2FormerDecoder
    from pairnet_torch.models.frameworks.psgtr import PSGTr
    from pairnet_torch.models.heads.pairnet_head import PairNetHead
    from pairnet_torch.models.layers import MSDeformAttention
    from pairnet_torch.models.necks.pixel_decoder import MSDeformAttnPixelDecoder

    if type(model) is not PSGTr or hasattr(model, "neck"):
        return False
    head = model.bbox_head
    return (type(model.backbone) in (ResNet, ResNeXt, SwinTransformer)
            and type(head) is PairNetHead
            and type(head.pixel_decoder) is MSDeformAttnPixelDecoder
            and type(head.transformer_decoder) is Mask2FormerDecoder
            and all(m.seq_group is None for m in model.modules()
                    if isinstance(m, MSDeformAttention)))


def _cut(model) -> None:
    """Make segments of the functions listed in the module's docstring, on
    ``model``'s instances: each instance's attribute wraps its own method
    in :func:`segment`."""
    head = model.bbox_head
    dec = head.transformer_decoder
    parts = [(model.backbone, "forward", "backbone"),
             (head.pixel_decoder, "forward", "pixel_decoder"),
             (head, "positions", "decoder.positions"),
             (dec, "_start", "decoder.start"), (dec, "_mask", "decoder.mask"),
             *((layer, "forward", "decoder_layer") for layer in dec.layers),
             (dec, "_head", "decoder.head"), (head, "pair", "pair")]
    for obj, attr, name in parts:
        if attr not in vars(obj):
            setattr(obj, attr, functools.partial(segment, name, getattr(obj, attr)))


def forward(model, images):
    """``model(images)``, from CUDA graphs where it can (see the module's
    docstring); the outputs are the forward's own or copies."""
    graphs = None
    if images.device.type == "cuda" and torch.is_inference_mode_enabled() and not model.training:
        if model not in _models:
            _models[model] = _ModelGraphs(model) if capturable(model) else None
        graphs = _models[model]
    if graphs is None:
        tracing.count("serve_graph.eager")
        return model(images)
    return graphs.forward(model, images)


def _tensors(tree) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


class _Reads(TorchFunctionMode):
    """While a segment is captured: the tensors that its torch functions
    read and that none of them made, by storage, for the graph to keep
    alive (the caches' device tensors, such as the MSDA's level sizes and
    Swin's masks, may drop theirs). It sees the Python calls only, so the
    operators run as they do without it; a buffer that only a hand-written
    kernel reads is not seen, and the ops keep theirs (the quantize's
    workspace)."""

    def __init__(self):
        super().__init__()
        self.made: set[int] = set()
        self.read: dict[int, torch.Tensor] = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors([args, kwargs]):
            ptr = t.untyped_storage().data_ptr()
            if ptr not in self.made:
                self.read.setdefault(ptr, t)
        out = func(*args, **kwargs)
        self.made.update(t.untyped_storage().data_ptr() for t in _tensors(out))
        return out


class _Segment(NamedTuple):
    name: str
    graph: torch.cuda.CUDAGraph
    inputs: list  # the tensors it was captured with
    out: object  # what it returned at capture, which each replay rewrites
    reads: list  # the tensors it reads that it did not make (_Reads)


class _Run:
    """One graphed forward: it captures ``segments``, in one pool, or
    replays them."""

    def __init__(self, segments: list, pool, stream):
        self.segments, self.pool, self.stream = segments, pool, stream
        self.capturing = stream is not None
        self.inside = False  # in a segment's body, at warm-up or capture
        self.index = 0  # the next segment to replay

    def segment(self, name, fn, args, kwargs):
        return (self._capture if self.capturing else self._replay)(name, fn, args, kwargs)

    def _capture(self, name, fn, args, kwargs):
        main, side = torch.cuda.current_stream(), self.stream
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        self.inside = True
        try:
            with torch.cuda.stream(side):
                fn(*args, **kwargs)  # lazy set-up, library choices and workspaces
                reads = _Reads()
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    with reads:
                        out = fn(*args, **kwargs)
                finally:
                    graph.capture_end()
        finally:
            self.inside = False
        main.wait_stream(side)  # the warm-up shares the quantize's workspace with the replays
        graph.replay()
        self.segments.append(_Segment(name, graph, _tensors([args, kwargs]), out,
                                      list(reads.read.values())))
        return out

    def _replay(self, name, fn, args, kwargs):
        seg = self.segments[self.index] if self.index < len(self.segments) else None
        have = _tensors([args, kwargs])
        if seg is None or seg.name != name or len(have) != len(seg.inputs):
            raise RuntimeError(f"serve_graph: the forward reached segment {name!r} where its "
                               f"capture had {seg.name if seg else 'none'!r}")
        self.index += 1
        for t, static in zip(have, seg.inputs):
            if t is static:
                continue
            if t.shape != static.shape:
                raise RuntimeError(f"serve_graph: segment {name!r} got {tuple(t.shape)} where "
                                   f"it was captured with {tuple(static.shape)}")
            if t.data_ptr() != static.data_ptr() or t.stride() != static.stride():
                static.copy_(t)
        seg.graph.replay()
        return seg.out


class _ModelGraphs:
    """A model's graphs by key, least recently used first; each key's
    segments in the order of capture."""

    def __init__(self, model):
        from pairnet_torch.models.layers import MSDeformAttention, MultiheadAttention

        _cut(model)
        self.tensors = [*model.parameters(), *model.buffers()]
        self.ptrs = None  # where they lay when the graphs were captured
        self.switches = [(m, "impl" if isinstance(m, MSDeformAttention) else "flash")
                         for m in model.modules()
                         if isinstance(m, (MSDeformAttention, MultiheadAttention))]
        self.keys: OrderedDict = OrderedDict()

    def forward(self, model, images):
        ptrs = tuple(map(torch.Tensor.data_ptr, self.tensors))
        if ptrs != self.ptrs:
            self.keys.clear()
            self.ptrs = ptrs
        key = (tuple(images.shape), images.dtype, images.device,
               tuple(getattr(m, attr) for m, attr in self.switches))
        segments = self.keys.get(key)
        if segments is not None:
            self.keys.move_to_end(key)
            out = self._run(model, images, _Run(segments, None, None))
            tracing.count("serve_graph.replays")
        else:
            if len(self.keys) >= KEYS:
                self.keys.popitem(last=False)
            dev = images.device.index
            if dev not in _streams:
                _streams[dev] = torch.cuda.Stream(images.device)
            segments = []
            with tracing.span("serve_graph.capture"):
                out = self._run(model, images, _Run(segments, torch.cuda.graph_pool_handle(),
                                                    _streams[dev]))
            self.keys[key] = segments
            tracing.count("serve_graph.captures")
        return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in out.items()}

    @staticmethod
    def _run(model, images, run: _Run):
        _local.run = run
        try:
            out = model(images)
        finally:
            _local.run = None
        if not run.segments:
            raise RuntimeError("serve_graph: the forward ran no segment")
        if not run.capturing and run.index != len(run.segments):
            raise RuntimeError(f"serve_graph: the forward ran {run.index} of the "
                               f"{len(run.segments)} segments captured")
        return out
