"""Captured CUDA graphs: the port's counterpart of ``jax.jit``.

The JAX package runs each step of its hot paths as one compiled program.
Here a function gets one ``torch.cuda.CUDAGraph`` per key, captured on its
first call and replayed on every later one, so the host enqueues one graph
launch where eager PyTorch issues every kernel itself.

The key of a call is built from its arguments:

- a tensor: its shape, strides, dtype and device.  Its values are copied
  (``copy_``) into the graph's own input tensor before every replay;
- a tensor marked :func:`state` (a KV cache, a loop's token and
  cross-attention buffers): its identity.  This is storage the graph was
  captured on: it reads and writes it in place, and nothing is copied;
- a number, a string, a dtype or device, ``None``: its value (the static
  arguments of the JAX decorators, such as ``heads``, ``nprobe``,
  ``backend``);
- a tuple, list or dict: its items;
- any other object (a parameter module, a ``DeviceIVF``): its identity.

A :class:`Graphs` holds the graphs of one owner, the object whose lifetime
matches theirs: a KV cache (the decode steps), a ``DeviceIVF`` (the
searches), a parameter module (the encoder), a loop's batch state.  Each
graph holds strong references to every tensor and object it was captured
on, so a freed address that is reused can never match a stale graph.  One
``Graphs`` is used by one thread at a time.

Outputs are returned fresh (cloned), as ``jit`` returns new arrays; what a
function writes into its state tensors is the one exception.

The first call of a key runs the function once on a side stream (the
warm-up: cuBLAS workspaces, the kernels' ``nvcc`` builds), puts back every
state tensor as it was, captures the function, then replays it.  The
launches the capture recorded in ``cuda_lib.launch_counts`` are added to
the counts at every replay; the warm-up's and the capture's own are taken
back out.  A capture synchronises the card, so one inside a
``set_sync_debug_mode("error")`` region fails loudly.  A capture or replay
that fails raises: nothing falls back to running eagerly.

A call runs the function eagerly on the CPU, inside
:func:`disable_capture` (the counterpart of ``jax.disable_jit``), and
inside another call's warm-up or capture, whose graph then holds its
kernels (as a jitted function called under ``jit`` is inlined).

Stage maps.  A replay drops the ``record_function`` ranges of the function
it captured, so the capture keeps a map of its spans instead
(``tracing.StageMap``): at each ``tracing.annotate`` span's entry and exit
it counts the device nodes (kernels, copies, sets) captured so far, and
the replay's nodes, in capture order, become runs of (innermost span,
nodes), those outside any span under the function's own name.  A call
inlined into a capture is a span of its function's name there.  While a
profiler records, each replay is a range named after the map::

    chamjax.graph <fn>: <span> <n>, <span> <n>, ...

A replay's device activities all carry its ``cudaGraphLaunch``'s
correlation id; one capture stream runs them in capture order, so in
start order they split into the map's runs (``portbench/spans.py`` reads
them, and leaves out a replay whose activities do not number the map's
total).  A capture is itself a host span, ``graphs.capture``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import gc
import numbers
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from chamjax_torch.utils import cuda_lib, tracing

# the devices whose calls are captured, and the graph class that captures
# them (the CPU tests stand a class in that re-runs the function)
CAPTURE_DEVICES = ("cuda",)
_STATE = "_chamjax_graph_state"
_local = threading.local()


def state(*tensors: torch.Tensor):
    """Mark tensors as state: a graph keys them by identity and reads and
    writes them in place.  Returns the tensor (or the tuple) given."""
    for t in tensors:
        setattr(t, _STATE, True)
    return tensors[0] if len(tensors) == 1 else tensors


def is_state(t: torch.Tensor) -> bool:
    return getattr(t, _STATE, False)


def _level(name: str) -> int:
    return getattr(_local, name, 0)


@contextlib.contextmanager
def _raised(name: str) -> Iterator[None]:
    setattr(_local, name, _level(name) + 1)
    try:
        yield
    finally:
        setattr(_local, name, _level(name) - 1)


def disable_capture():
    """Context manager: inside it every call runs eagerly, on this thread
    (the counterpart of ``jax.disable_jit``)."""
    return _raised("disabled")


class CudaGraph:
    """One ``torch.cuda.CUDAGraph``, with its own memory pool."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        self._on_device: Dict[int, bool] = {}   # node → runs on the device

    def device_nodes(self) -> int:
        """The kernel, memcpy and memset nodes captured so far (called
        inside ``capture``, on the capture stream)."""
        nodes = cuda_lib.capture_nodes(
            torch.cuda.current_stream(self.device).cuda_stream)
        for node in nodes:
            if node not in self._on_device:
                self._on_device[node] = (cuda_lib.node_type(node)
                                         in cuda_lib.DEVICE_NODE_TYPES)
        return sum(self._on_device[node] for node in nodes)

    def warm_up(self, run: Callable[[], Any]) -> None:
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            run()
        current.wait_stream(side)

    def capture(self, run: Callable[[], Any]) -> Any:
        # no garbage collection while capturing: a dead cycle collected
        # here can free CUDA objects (another graph and its memory pool)
        # with calls a capture forbids, which invalidates the capture
        # ("operation failed due to a previous error during capture")
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(
                    self.graph, capture_error_mode="thread_local"):
                return run()
        finally:
            if gc_was_on:
                gc.enable()

    def replay(self) -> None:
        self.graph.replay()


Graph = CudaGraph


class _Call:
    """A call's arguments taken apart: its key, the tensors copied into the
    graph's inputs, the state tensors and the other objects it holds."""

    def __init__(self, args: tuple, kwargs: dict):
        self.inputs: List[torch.Tensor] = []
        self.states: List[torch.Tensor] = []
        self.held: List[Any] = []
        self.key = (self._key(args), self._key(kwargs))
        first = next(iter(self.inputs + self.states), None)
        self.device = first.device if first is not None else None

    def _key(self, x):
        if isinstance(x, torch.Tensor):
            if is_state(x):
                self.states.append(x)
                return ("state", id(x))
            self.inputs.append(x)
            return ("tensor", tuple(x.shape), x.stride(), x.dtype, x.device)
        if x is None or isinstance(x, (numbers.Number, str, torch.dtype,
                                       torch.device)):
            return (type(x), x)
        if isinstance(x, (tuple, list)):
            return (type(x), tuple(self._key(y) for y in x))
        if isinstance(x, dict):
            return (dict, tuple((k, self._key(x[k])) for k in sorted(x)))
        self.held.append(x)
        return ("object", id(x))


def _swap(x, inputs: Iterator[torch.Tensor]):
    """``x`` with each tensor that is not state replaced by the next of
    ``inputs``, in the order ``_Call`` met them."""
    if isinstance(x, torch.Tensor):
        return x if is_state(x) else next(inputs)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_swap(y, inputs) for y in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_swap(y, inputs) for y in x)
    if isinstance(x, dict):
        return {k: _swap(x[k], inputs) for k in sorted(x)}
    return x


def _fresh(x):
    """``x`` with every tensor cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_fresh(y) for y in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_fresh(y) for y in x)
    if isinstance(x, dict):
        return {k: _fresh(v) for k, v in x.items()}
    return x


@dataclasses.dataclass
class _Captured:
    graph: Any
    inputs: List[torch.Tensor]      # the graph's own input tensors
    outputs: Any                    # the graph's output tensors
    held: List[Any]                 # what it was captured on
    launches: collections.Counter   # kernel launches a replay makes
    stages: Tuple[Tuple[str, int], ...]  # the stage map: (span, nodes)
    name: str                       # a replay's range, the map in it


def _capture(fn: Callable, args: tuple, kwargs: dict, c: _Call) -> _Captured:
    inputs = [t.clone() for t in c.inputs]
    it = iter(inputs)
    run = functools.partial(fn, *_swap(args, it), **_swap(kwargs, it))
    counts = collections.Counter(cuda_lib.launch_counts)
    saved = [t.clone() for t in c.states]
    graph = Graph(c.device)
    stages = tracing.StageMap(fn.__name__, graph.device_nodes)
    try:
        with _raised("depth"):
            graph.warm_up(run)
            before = collections.Counter(cuda_lib.launch_counts)
            outputs = graph.capture(functools.partial(stages.record, run))
        launches = collections.Counter(cuda_lib.launch_counts)
        launches.subtract(before)
    finally:
        cuda_lib.launch_counts.clear()
        cuda_lib.launch_counts.update(counts)
    # the warm-up ran the function (a decode step wrote a cache column and
    # advanced idx): put the state back as the call found it
    for t, s in zip(c.states, saved):
        t.copy_(s)
    runs = stages.result()
    name = f"chamjax.graph {fn.__name__}: " + ", ".join(
        f"{span} {n}" for span, n in runs)
    return _Captured(graph, inputs, outputs, c.states + c.held, +launches,
                     runs, name)


def _captures(device: Optional[torch.device]) -> bool:
    if (device is None or device.type not in CAPTURE_DEVICES
            or _level("disabled") or _level("depth")):
        return False
    return not (device.type == "cuda"
                and torch.cuda.is_current_stream_capturing())


class Graphs:
    """The captured graphs of one owner, one per key."""

    def __init__(self) -> None:
        self._graphs: Dict[Any, _Captured] = {}

    def __len__(self) -> int:
        return len(self._graphs)


def call(owner: Optional[Graphs], fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)``: on the card, a replay of the graph that
    ``owner`` holds for this call's key, captured first if there is none;
    elsewhere, and under :func:`disable_capture`, ``fn`` itself."""
    c = _Call(args, kwargs)
    if not _captures(c.device):
        stages = tracing.open_stage_map()
        if stages is None:
            return fn(*args, **kwargs)
        with stages.span(fn.__name__):      # inlined into a capture
            return fn(*args, **kwargs)
    if owner is None:
        raise ValueError(f"{fn.__name__}: no Graphs to own its capture")
    key = (fn, c.key)
    g = owner._graphs.get(key)
    if g is None:
        with tracing.annotate("graphs.capture"):
            g = owner._graphs[key] = _capture(fn, args, kwargs, c)
    for static, t in zip(g.inputs, c.inputs):
        static.copy_(t)
    with tracing.annotate(g.name):
        g.graph.replay()
    cuda_lib.launch_counts.update(g.launches)
    return _fresh(g.outputs)


def captured(fn: Callable) -> Callable:
    """Decorator: calls of ``fn`` go through :func:`call`, their graphs
    owned by the ``graphs`` of ``fn``'s first argument."""
    @functools.wraps(fn)
    def wrapper(owner, *args, **kwargs):
        return call(owner.graphs, fn, owner, *args, **kwargs)
    return wrapper
