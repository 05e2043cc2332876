"""The compiled step: the port's counterpart of `jax.jit(step)` scanned
over a sequence.

The JAX package compiles `step(carry, frame) -> (carry, out)` once with
XLA and runs sequences under `lax.scan` (vio_msckf_tpu/engine.py). Here
`CompiledStep(fn)` captures one call of fn as a CUDA graph, once per
frame shape, and replays it per frame; fn works on trees of tensors (the
port's records, dicts, tuples, lists; tensors.tree_map).

A captured step holds one static buffer per carry leaf and per frame
leaf. The graph runs fn on them and then copies the new carry into the
static carry, so the next replay reads it. Per frame the runner copies
the caller's frame in, replays, and copies the outputs out; a run hands
its carry back as clones, which never alias the static buffers.

  * Warm-up: the first frame of the first run at a shape runs eagerly, as
    the sequence's real step, on the stream the capture then uses. That
    builds and loads the hand kernels (kernels.lib()), creates the cuBLAS
    and cuSOLVER handles and workspaces and fills the port's per-device
    constants (e.g. ORB's patterns): none of that may happen inside a
    capture. No frame is stepped twice.
  * Linear algebra: the warm-up and the capture run under
    `capturable_linalg()` (cuSOLVER and cuBLAS, not MAGMA), and so must
    the eager step the graph is held against.
  * Ownership: a step that is a bound method is held weakly, so an owner
    that holds its CompiledStep (VIOEngine, EskfVio) forms no reference
    cycle with it: dropping the owner frees its graphs and their memory
    pools at once, never in the middle of a later capture.
  * Cache: per owner (`CompiledStep`), keyed on the frame's shapes,
    dtypes and device (B is the frames' leading axis; the number of frames
    in a run is not part of the key), like a jit cache.
  * Launch counters: the hand kernels' wrappers count their launches in
    Python (`by_shape`), and a replay calls no Python. The counts a
    capture makes are taken back and added again on every replay, so
    `kernels.launch_counts()` stays what an eager run would count
    (chip_smoke.py holds these counts against torch.profiler's kernel
    table of replays and of a whole graphed run).
  * What a captured step must keep: no host synchronisation, no
    host-to-device copy, no Python value that changes between frames
    (ROADMAP ground rules; the eager step has none). A capture that fails
    raises: there is no eager fallback on CUDA.
  * Collectives: a step sharded over a block process group (`group`,
    parallel/) is captured with its collectives inside the graph when the
    group is NCCL's (one rank per card), and steps eagerly when it is
    gloo's, whose collectives stage through the host
    (comm.capturable). The warm-up frame runs every collective of the
    step eagerly, so the group's NCCL communicator exists before the
    capture. Every rank of a group captures and replays the same graphs
    in the same order, as it issues the same collectives.
  * Capture mode: every step is captured in "thread_local" mode, so that
    another thread of the process (NCCL's watchdog, which queries the
    events of earlier collectives whenever a process group exists) cannot
    invalidate the capture as it could under the default "global" mode.

On a CPU tensor the runner calls fn directly: the CPU has no graphs.
"""

import collections
import contextlib
import inspect
import time
import weakref

import torch

from vio_msckf_torch import comm, kernels
from vio_msckf_torch.tensors import tree_leaves, tree_map


def _storage(t):
    return t.untyped_storage().data_ptr()


def _same_layout(dst, src, what):
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"{what}: expected {tuple(dst.shape)} {dst.dtype}, got "
                         f"{tuple(src.shape)} {src.dtype}")


def _captures(frame):
    """Whether steps on this frame are captured (CUDA) or called (CPU)."""
    return tree_leaves(frame)[0].is_cuda


@contextlib.contextmanager
def _capture_stream(device):
    """Run the block on a new side stream that first waits for the current
    stream, which then waits for it. Yields (the side stream, a list): the
    tensors the block appends to the list are marked as used on the
    current stream, so that their memory is not reused while it reads
    them."""
    current = torch.cuda.current_stream(device)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(current)
    made = []
    with torch.cuda.stream(stream):
        yield stream, made
    current.wait_stream(stream)
    for t in made:
        t.record_stream(current)


@contextlib.contextmanager
def capturable_linalg():
    """Dense linear algebra on cuSOLVER and cuBLAS inside the block; the
    process's own choice comes back after it.

    PyTorch's default heuristic sends the filter's batched 141x141
    `solve_ex` (B > 1 sequences, filter/update.py:qr_update) to MAGMA's
    batched LU, which makes a CUDA call that a graph capture does not
    permit; cuSOLVER and cuBLAS capture. The runner warms up and captures
    in this block, and the eager steps it is held against
    (VIOEngine.step_batch, EskfVio.step) run in it too, so graph and eager
    use one library and agree bit for bit."""
    if not torch.backends.cuda.is_built():
        yield
        return
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


def _called(handle):
    """The step behind a weak handle (weakref.WeakMethod, or a function
    returning a plain function)."""
    fn = handle()
    if fn is None:
        raise ReferenceError("the object whose step is compiled is gone")
    return fn


def _capture(body, stream):
    """One call of body() captured on `stream` in "thread_local" mode
    (module docstring): (the graph, what body returned; each replay
    rewrites those tensors)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
        out = body()
    return graph, out


class StepGraph:
    """One call of the step captured at the shapes of (carry, frame): the
    static carry, frame and output buffers, and the launches of the call.
    `step` is CompiledStep's weak handle to the step function."""

    def __init__(self, step, carry, frame, stream):
        self._step = step
        self.carry = tree_map(torch.clone, carry)
        self.frame = tree_map(lambda t: t.clone(memory_format=torch.contiguous_format), frame)
        self._static = {_storage(t) for t in tree_leaves((self.carry, self.frame))}
        self._wrappers = kernels.counters()
        before = {k: collections.Counter(w.by_shape) for k, w in self._wrappers.items()}
        t0 = time.perf_counter()
        self.launches = {}
        try:
            with capturable_linalg():
                self.graph, self.out = _capture(self._body, stream)
        finally:
            # The capture launched nothing: take its counts back.
            for k, w in self._wrappers.items():
                self.launches[k] = w.by_shape - before[k]
                w.by_shape.clear()
                w.by_shape.update(before[k])
        self.capture_s = time.perf_counter() - t0

    def _body(self):
        """What the graph holds: fn on the static buffers, then the new
        carry copied into the static carry. A leaf that shares storage with
        a static buffer (an old carry leaf handed back in another place, an
        output that is a carry or frame buffer) is cloned first, so that no
        copy reads what another copy has already overwritten and no output
        shows a later value."""
        new_carry, out = _called(self._step)(self.carry, self.frame)

        def own(t):
            return t.clone() if _storage(t) in self._static else t

        out = tree_map(own, out)
        dst, src = tree_leaves(self.carry), tree_leaves(new_carry)
        if len(dst) != len(src):
            raise ValueError(f"the step returned a carry of {len(src)} tensors, "
                             f"took one of {len(dst)}")
        src = [own(t) for t in src]
        for d, s in zip(dst, src):
            _same_layout(d, s, "the step's new carry")
            d.copy_(s)
        return out

    def load(self, carry):
        """Copy a carry into the static carry (a new run's first frame)."""
        for d, s in zip(tree_leaves(self.carry), tree_leaves(carry)):
            _same_layout(d, s, "carry")
            d.copy_(s)

    def replay(self, frame):
        """One step from the static carry: copy the frame in, replay, count
        the launches. Returns the static outputs, which the next replay
        overwrites."""
        for d, s in zip(tree_leaves(self.frame), tree_leaves(frame)):
            _same_layout(d, s, "frame")
            d.copy_(s)
        self.graph.replay()
        for k, n in self.launches.items():
            self._wrappers[k].by_shape.update(n)
        return self.out


class CompiledStep:
    """fn(carry, frame) -> (carry, out), captured once per frame shape and
    replayed per frame (module docstring).

        step = CompiledStep(fn)
        carry, outs = step.run(carry, frames, axis)   # frames stacked on axis

    One run at a time: a run's carry lives in the graph's static buffers
    until the run returns it. `group`: the block process group whose
    collectives fn issues; a gloo group makes fn run eagerly on every
    device (module docstring)."""

    def __init__(self, fn, group=None):
        self._fn = weakref.WeakMethod(fn) if inspect.ismethod(fn) else lambda: fn
        self.group = group
        self.capture = comm.capturable(group)
        self.graphs = {}

    @property
    def fn(self):
        return _called(self._fn)

    def clear(self):
        """Drop the captured graphs, and with them their memory pools."""
        self.graphs.clear()

    def _first(self, carry, frame):
        """The run's first frame: a replay of the cached graph, or the
        eager warm-up step followed by the capture. Returns (graph, out)."""
        leaves = tree_leaves(frame)
        key = tuple((tuple(t.shape), t.dtype) for t in leaves) + (leaves[0].device,)
        graph = self.graphs.get(key)
        if graph is not None:
            graph.load(carry)
            return graph, graph.replay(frame)
        with _capture_stream(leaves[0].device) as (stream, made), capturable_linalg():
            carry, out = self.fn(carry, frame)
            made += tree_leaves((carry, out))
        # The static carry starts as a clone of the warm-up's new carry.
        graph = self.graphs[key] = StepGraph(self._fn, carry, frame, stream)
        return graph, out

    def __call__(self, carry, frame, axis=0):
        """One frame: run() over the frame stacked alone on `axis`, as one
        call of a jitted step."""
        carry, out = self.run(carry, tree_map(lambda v: v.unsqueeze(axis), frame), axis)
        return carry, tree_map(lambda t: t.select(axis, 0), out)

    def run(self, carry, frames, axis=0):
        """Step over frames stacked on `axis` (0 for one sequence, 1 for
        (B, T, ...)); returns (carry, outputs stacked on the same axis)."""
        n = tree_leaves(frames)[0].shape[axis]
        if n == 0:
            raise ValueError("no frames to step over")
        graph, outs = None, None
        for k in range(n):
            frame = tree_map(lambda v: v.select(axis, k), frames)
            if graph is not None:
                out = graph.replay(frame)
            elif self.capture and _captures(frame):
                graph, out = self._first(carry, frame)
            else:
                carry, out = self.fn(carry, frame)
            if outs is None:
                outs = tree_map(lambda t: t.new_empty(t.shape[:axis] + (n,) + t.shape[axis:]),
                                out)
            for buf, o in zip(tree_leaves(outs), tree_leaves(out)):
                buf.select(axis, k).copy_(o)
        if graph is not None:
            carry = tree_map(torch.clone, graph.carry)
        return carry, outs

