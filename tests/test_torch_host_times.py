"""The ring of host times in ``codec_cuda``: each ``compress_device`` and
``decompress_device`` call that returns keeps its direction, its entry and
exit stamps on ``time.time_ns()``, the ns inside ``_launch`` and whether its
spans were recorded, in a ring of the newest ``HOST_TIMES`` calls that
``host_times()`` reads with no profiler. On the CPU through the API with
its bodies (``_compress``, ``_decompress``) replaced by stand-ins, since a
host tensor is refused; on a card (marker ``cuda``) through the API as it
is."""

import json
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from ndzip_tpu_torch import codec_cuda, utils  # noqa: E402
from ndzip_tpu_torch import format as fmt  # noqa: E402


@pytest.fixture(autouse=True)
def empty_ring(monkeypatch):
    """The ring refilled with ``None`` as at import, and given back after;
    verbose off."""
    ring, saved = codec_cuda._RING, list(codec_cuda._RING)
    ring.extend([None] * codec_cuda.HOST_TIMES)
    monkeypatch.delenv(utils.VERBOSE_ENV, raising=False)
    utils.verbose.cache_clear()
    yield
    utils.verbose.cache_clear()
    ring.extend(saved)


@pytest.fixture
def bodies(monkeypatch):
    """The API's bodies replaced by ``body()``, where the caller passes
    ``body`` for the tensor: it returns ``(result, launch ns)``."""
    monkeypatch.setattr(codec_cuda, "_compress", lambda body: body())
    monkeypatch.setattr(codec_cuda, "_decompress", lambda body, shape, dtype: body())


LABELS = {"compress": "ndzip.compress_device", "decompress": "ndzip.decompress_device"}


def _call(direction, launch_ns=7, result="out", body=None):
    """One API call whose body returns ``result`` at once, or runs ``body``."""
    body = body or (lambda: (result, launch_ns))
    if direction == "compress":
        return codec_cuda.compress_device(body)
    return codec_cuda.decompress_device(body, (4,))


def test_the_ring_is_empty_until_a_call_returns(bodies):
    assert codec_cuda.host_times() == []
    assert _call("compress", result=("stream", "length")) == ("stream", "length")
    (call,) = codec_cuda.host_times()
    assert call.direction == "compress" and call.launch_ns == 7 and not call.spanned
    assert 0 <= call.entry_ns <= call.exit_ns


def test_the_ring_wraps_at_its_size_and_keeps_the_newest_calls_oldest_first(bodies):
    n = codec_cuda.HOST_TIMES
    assert n >= 4096 and len(codec_cuda._RING) == n  # preallocated
    for i in range(n + 5):
        _call("decompress" if i % 3 else "compress", launch_ns=i)
    calls = codec_cuda.host_times()
    assert len(calls) == n == len(codec_cuda._RING)
    assert [c.launch_ns for c in calls] == list(range(5, n + 5))
    assert all(a.exit_ns <= b.entry_ns for a, b in zip(calls, calls[1:]))


def test_each_call_keeps_its_direction(bodies):
    directions = ["compress", "decompress", "decompress", "compress", "decompress"]
    for d in directions:
        _call(d)
    assert [c.direction for c in codec_cuda.host_times()] == directions


def test_a_call_that_raises_keeps_no_entry(bodies, monkeypatch):
    def fail():
        raise ValueError("refused")

    with pytest.raises(ValueError, match="refused"):
        _call("compress", body=fail)
    monkeypatch.undo()  # the API as it is refuses a host tensor inside its span
    with pytest.raises(ValueError, match="CUDA device"):
        codec_cuda.compress_device(torch.zeros((64, 64)))
    with pytest.raises(ValueError, match="CUDA device"):
        codec_cuda.decompress_device(torch.zeros(64, dtype=torch.int32), (64, 64))
    assert codec_cuda.host_times() == []


@pytest.mark.parametrize("listener", ["none", "profiler", "verbose"])
def test_the_span_flag_says_whether_the_spans_were_recorded(bodies, monkeypatch, capsys, listener):
    if listener == "verbose":
        monkeypatch.setenv(utils.VERBOSE_ENV, "1")
    if listener == "profiler":
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            _call("decompress")
    else:
        _call("decompress")
    _call("compress")  # the listener gone, except verbose, which stays set
    first, second = codec_cuda.host_times()
    assert first.spanned == (listener != "none")
    assert second.spanned == (listener == "verbose")
    assert ("[profile] ndzip.decompress_device" in capsys.readouterr().err) == (listener == "verbose")


@pytest.mark.parametrize("threads", [2, 16])
def test_two_threads_recording_at_once_never_mix_their_stamps(bodies, threads):
    """Threads (16: more than the cores) call at once, with the
    interpreter's switch interval shortened, while another reads the ring:
    every call keeps exactly one entry, named by its launch ns (thread,
    call), with its thread's direction and stamps within the window its own
    thread saw around it; the threads' calls overlap in time, and every read
    gives whole entries."""
    calls, barrier, seen, reads, done = 300, threading.Barrier(threads + 1), {}, [], threading.Event()

    def reader():
        barrier.wait()
        while not done.is_set():
            reads.append(codec_cuda.host_times())

    def worker(k):
        direction = "compress" if k % 2 else "decompress"
        barrier.wait()
        for j in range(calls):
            name = 1_000_000 * (k + 1) + j

            def body():
                time.sleep(0 if j % 2 else 1e-5)
                return None, name

            before = time.time_ns()
            _call(direction, body=body)
            seen[name] = (direction, before, time.time_ns())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=worker, args=(k,)) for k in range(threads)]
        watcher = threading.Thread(target=reader)
        for t in pool + [watcher]:
            t.start()
        for t in pool:
            t.join(timeout=60)
        done.set()
        watcher.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool + [watcher])
    assert reads and all(len(r) <= threads * calls for r in reads)
    assert all(all(len(c) == 5 and c.exit_ns >= c.entry_ns for c in r) for r in reads)
    ring = codec_cuda.host_times()
    assert len(ring) == threads * calls and sorted(c.launch_ns for c in ring) == sorted(seen)
    for c in ring:
        direction, before, after = seen[c.launch_ns]
        assert c.direction == direction
        assert before <= c.entry_ns <= c.exit_ns <= after
    windows = [(min(c.entry_ns for c in ring if c.launch_ns // 1_000_000 == k + 1),
                max(c.exit_ns for c in ring if c.launch_ns // 1_000_000 == k + 1)) for k in range(2)]
    assert windows[0][0] < windows[1][1] and windows[1][0] < windows[0][1]


def test_each_call_lies_inside_its_span_on_the_traces_clock(bodies, tmp_path):
    """A chrome trace's ``ts`` (us) times 1000 plus its
    ``baseTimeNanoseconds`` is ``time.time_ns()``: each call of the ring,
    so converted, lies inside its own ``ndzip.*`` span."""
    directions = ["compress", "decompress"] * 20
    with utils.profiler_trace(tmp_path):
        for i, d in enumerate(directions):
            _call(d, launch_ns=i)
    (path,) = list(tmp_path.glob("*.pt.trace.json"))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    spans = sorted((e["ts"], e["dur"], e["name"]) for e in trace["traceEvents"]
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation")
    ring = codec_cuda.host_times()
    assert [s[2] for s in spans] == [LABELS[d] for d in directions] and len(ring) == len(directions)
    for (ts, dur, _), c in zip(spans, ring):
        assert c.spanned
        assert ts * 1000 + base <= c.entry_ns <= c.exit_ns <= (ts + dur) * 1000 + base


# ------------------------------------------------------------ on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, shape", [(torch.float32, (1800, 3600)), (torch.float32, (1 << 20,)),
                                          (torch.float64, (64, 64, 96)), (torch.float32, (10, 10)),
                                          (torch.float64, (7, 3))],
                         ids=["fp32-2d", "fp32-1d", "fp64-3d", "fp32-border", "fp64-border"])
def test_each_api_call_keeps_one_entry_with_its_launch_time(cuda, dtype, shape):
    """Three round trips: one entry a call, in order; on a kernel's path a
    launch time above 0 and under the call's, on the border path 0."""
    x = torch.randn(shape, dtype=dtype, device=cuda)
    border = fmt.num_hypercubes(shape) == 0
    for _ in range(3):
        stream, length = codec_cuda.compress_device(x)
        out = codec_cuda.decompress_device(stream[: int(length)], shape, dtype)
    torch.cuda.synchronize()
    assert torch.equal(out, x)
    ring = codec_cuda.host_times()
    assert [c.direction for c in ring] == ["compress", "decompress"] * 3
    assert not any(c.spanned for c in ring)
    for c in ring:
        if border:
            assert c.launch_ns == 0 and c.exit_ns > c.entry_ns
        else:
            assert 0 < c.launch_ns < c.exit_ns - c.entry_ns
