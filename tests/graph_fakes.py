"""Stand-ins for torch.cuda's stream and graph calls, so that
`utils/cuda_graph.LoopStep` captures and replays on CPU tensors. Imports
nothing of jax: the tests marked `cuda` of a file that uses them run on a
machine without it."""

import contextlib

import torch


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph: its capture runs the step's Python
    and records the step's device work (`_kernel`) without running it, as a
    real capture does; its replay runs what the capture recorded."""

    capturing = None

    def __init__(self):
        self.work = []

    def replay(self):
        for fn in self.work:
            fn()


@contextlib.contextmanager
def _fake_capture(graph, **kw):
    _FakeGraph.capturing = graph
    try:
        yield
    finally:
        _FakeGraph.capturing = None


def _kernel(fn):
    """Device work of a stand-in step: run now, or recorded by the capture."""
    if _FakeGraph.capturing is None:
        fn()
    else:
        _FakeGraph.capturing.work.append(fn)


@contextlib.contextmanager
def _fake_cuda(monkeypatch):
    """torch.cuda's stream and graph calls replaced so that
    `LoopStep._capture` runs on CPU tensors."""
    stream = type("S", (), {"wait_stream": lambda self, other: None})
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    yield
