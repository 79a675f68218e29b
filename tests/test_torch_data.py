"""The port's input path against the JAX package's, on the CPU: samplers,
the resumable state, datasets, the DataLoader, DevicePrefetcher, the
vision datasets and transforms, the callbacks, and the Trainer's
pipeline hook.

The same numpy seed goes through both packages; batches, orders and
states compare bitwise (uint8, int and float32 alike: tolerance 0).
Process-worker loaders of the port are held against the JAX package's
in-process loader (its own tests hold its transports equal), and are few
(three cases, two workers at most): each spawned worker imports torch.
The reference's behavioural cases are ported too: an early break leaves
no worker threads or processes, worker errors carry their batch and
samples, the data-fault sites, the synchronous ``MXTPU_DEVICE_PREFETCH=0``
path, and a source's exception reaching the consumer.
"""

import logging
import multiprocessing
import random
import struct
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import gluon as jgluon

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.context import cpu
from mxnet_tpu_torch.gluon.data import (DataLoader, DataLoaderWorkerError,
                                        DevicePrefetcher)
from torch_data_samples import FailingDataset, PairDataset, sum_batchify
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.delenv("MXTPU_DEVICE_PREFETCH", raising=False)
    monkeypatch.delenv("MXTPU_TELEMETRY_PATH", raising=False)
    ttel.reset()
    with cpu():
        yield
    ttel.reset()


@pytest.fixture
def faults(monkeypatch):
    from mxnet_tpu_torch import resilience

    def arm(spec):
        monkeypatch.setenv("MXTPU_FAULT_INJECT", spec)
        resilience.reset_faults()

    yield arm
    monkeypatch.delenv("MXTPU_FAULT_INJECT", raising=False)
    resilience.reset_faults()


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(got, want):
    """Two batch streams (arrays or lists of arrays) equal bitwise."""
    got, want = _np(list(got)), _np(list(want))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, list):
            _same(g, w)
        else:
            assert g.shape == w.shape, (g.shape, w.shape)
            np.testing.assert_array_equal(g, w)


def _index_ds(pkg, n):
    return pkg.gluon.data.SimpleDataset(np.arange(n, dtype=np.int64))


def _vals(batch):
    return [int(v) for v in _np(batch).ravel()]


def _drain(source):
    return [v for b in source for v in _vals(b)]


# -- state and samplers --------------------------------------------------------

@pytest.mark.parametrize("world", [1, 3])
def test_epoch_order_and_state_match_jax(world):
    from mxnet_tpu.gluon.data import state as jstate

    from mxnet_tpu_torch.gluon.data import state as tstate

    for seed, epoch in ((0, 0), (5, 3), (2 ** 33 + 7, 1)):
        np.testing.assert_array_equal(tstate.epoch_order(seed, epoch, 50),
                                      jstate.epoch_order(seed, epoch, 50))
    for rank in range(world):
        t = tstate.DataPipelineState(29, seed=9, rank=rank, world=world)
        j = jstate.DataPipelineState(29, seed=9, rank=rank, world=world)
        for st in (t, j):
            st.advance(4)
            st.skip(2)
            st.quarantine([(0, 5)])
        np.testing.assert_array_equal(t.shard(), j.shard())
        assert t.shard_len() == j.shard_len() == len(t.shard())
        assert t.state_dict() == j.state_dict()
        t2 = tstate.DataPipelineState(29, rank=0, world=world + 1)
        t2.load_state_dict(j.state_dict())
        assert (t2.cursor, t2.world) == (t.cursor, world + 1)
    with pytest.raises(ValueError, match="samples"):
        tstate.DataPipelineState(30).load_state_dict(t.state_dict())


def test_samplers_match_jax():
    from mxnet_tpu.gluon.contrib.data import IntervalSampler as JInterval

    from mxnet_tpu_torch.gluon.contrib.data import IntervalSampler

    tdata, jdata = tgluon.data, jgluon.data
    np.random.seed(3)
    trand = list(tdata.RandomSampler(20))
    np.random.seed(3)
    assert trand == list(jdata.RandomSampler(20))
    assert list(tdata.SequentialSampler(5, start=2)) == \
        list(jdata.SequentialSampler(5, start=2))
    for mode in ("keep", "discard", "rollover"):
        tb = tdata.BatchSampler(tdata.SequentialSampler(10), 4, mode)
        jb = jdata.BatchSampler(jdata.SequentialSampler(10), 4, mode)
        for _ in range(2):      # rollover carries the tail into epoch 2
            assert (len(tb), list(tb)) == (len(jb), list(jb))
    ds = list(range(12))
    assert list(tdata.FilterSampler(lambda x: x % 3 == 0, ds)) == \
        list(jdata.FilterSampler(lambda x: x % 3 == 0, ds))
    for rollover in (True, False):
        t, j = IntervalSampler(10, 3, rollover), JInterval(10, 3, rollover)
        assert (len(t), list(t)) == (len(j), list(j))
    with pytest.raises(ValueError, match="last_batch"):
        list(tdata.BatchSampler(tdata.SequentialSampler(3), 2, "bogus"))


# -- datasets ------------------------------------------------------------------

def test_datasets_match_jax(tmp_path):
    from mxnet_tpu.gluon.contrib.data import CharTokenDataset as JChar
    from mxnet_tpu import recordio as jrec

    from mxnet_tpu_torch.gluon.contrib.data import CharTokenDataset

    x = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    out = []
    for pkg in (tmx, jmx):
        data = pkg.gluon.data
        arr = data.ArrayDataset(x, pkg.nd.array(y))
        lazy = arr.transform(lambda a, b: (a * 2, b + 1))
        first = arr.transform_first(lambda a: a.sum(), lazy=False)
        simple = data.SimpleDataset(list(range(10)))
        out.append([_np(arr[3]), _np(lazy[4]), _np(first[5]),
                    [[v for v in simple.shard(3, i)] for i in range(3)],
                    [simple.take(4)[k] for k in range(4)],
                    [v for v in simple.filter(lambda v: v % 2)]])
    assert repr(out[0]) == repr(out[1])
    path = str(tmp_path / "r.rec")
    w = jrec.MXIndexedRecordIO(str(tmp_path / "r.idx"), path, "w")
    for i in range(5):
        w.write_idx(i, bytes([i]) * (i + 1))
    w.close()
    rd = tgluon.data.RecordFileDataset(path)
    assert [rd[i] for i in range(len(rd))] == \
        [bytes([i]) * (i + 1) for i in range(5)]
    text = "the quick brown fox jumps over the lazy dog " * 5
    t, j = CharTokenDataset(text, seq_len=16), JChar(text, seq_len=16)
    assert len(t) == len(j) and t.vocab == j.vocab
    for i in range(len(t)):
        for a, b in zip(t[i], j[i]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        CharTokenDataset(str(tmp_path / "missing.txt"))


# -- DataLoader ----------------------------------------------------------------

LOADER_CASES = {
    "same_process": dict(batch_size=5),
    "threads": dict(batch_size=5, num_workers=2),
    "threads_shuffled": dict(batch_size=6, num_workers=3, shuffle=True),
    "discard": dict(batch_size=8, last_batch="discard", num_workers=2),
    "rollover": dict(batch_size=8, last_batch="rollover"),
    "custom_batchify": dict(batch_size=4, num_workers=2,
                            batchify_fn=sum_batchify),
    "prefetch_0": dict(batch_size=5, num_workers=2, prefetch=0),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_match_jax(case):
    kw = LOADER_CASES[case]
    got, want = [], []
    for pkg, out in ((tmx, got), (jmx, want)):
        np.random.seed(11)
        loader = pkg.gluon.data.DataLoader(PairDataset(), **kw)
        for _ in range(2):      # two epochs: rollover carries its tail
            out.append(list(loader))
    for g, w in zip(got, want):
        _same(g, w)
    if case != "custom_batchify":
        assert got[0][0][0].context == cpu()
        assert got[0][0][2].dtype == np.int32   # as the JAX package's


def test_loader_process_workers_match_jax():
    want = list(jgluon.data.DataLoader(PairDataset(), batch_size=6))
    loader = DataLoader(PairDataset(), batch_size=6, num_workers=2,
                        thread_pool=False)
    _same(loader, want)
    # the same workers straight into the prefetcher (host arrays)
    _same(DevicePrefetcher(loader, depth=2), want)
    assert not [p for p in multiprocessing.active_children()
                if p.is_alive()]


def test_pinned_loader_gives_host_batches():
    want = list(DataLoader(PairDataset(), batch_size=6))
    got = list(DataLoader(PairDataset(), batch_size=6, pin_memory=True,
                          num_workers=2))
    _same(got, want)
    assert all(a.context == cpu() for b in got for a in b)


@pytest.mark.parametrize("num_workers", [0, 2])
def test_resumable_loader_matches_jax_and_resumes_exactly_once(num_workers):
    n, bs = 40, 8
    mk = lambda pkg, seed: pkg.gluon.data.DataLoader(  # noqa: E731
        _index_ds(pkg, n), batch_size=bs, shuffle=True, seed=seed,
        num_workers=num_workers)
    loader, jloader = mk(tmx, 5), mk(jmx, 5)
    it, jit = iter(loader), iter(jloader)
    first = []
    for _ in range(2):
        b, jb = next(it), next(jit)
        _same([b], [jb])
        first.extend(_vals(b))
    sd = loader.state_dict()
    assert sd == jloader.state_dict() and sd["cursor"] == 16
    getattr(it, "close", lambda: None)()
    fresh = mk(tmx, 0)
    fresh.load_state_dict(sd)
    rest = _drain(fresh)
    assert sorted(first + rest) == list(range(n))
    assert ttel.event_counts().get("data_resume") == 1
    assert sorted(_drain(fresh)) == list(range(n))   # a fresh epoch
    assert fresh.state_dict()["epoch"] == 2


def test_elastic_reshape_and_quarantine_are_exactly_once():
    n, bs = 48, 4
    mk = lambda r, w: DataLoader(_index_ds(tmx, n),  # noqa: E731
                                 batch_size=bs, shuffle=True, seed=13,
                                 rank=r, world_size=w)
    before = []
    old = [mk(r, 3) for r in range(3)]
    for loader in old:
        it = iter(loader)
        for _ in range(2):
            before.extend(_vals(next(it)))
    after = []
    for loader in (mk(0, 2), mk(1, 2)):
        loader.load_state_dict(old[0].state_dict())
        after.extend(_drain(loader))
    assert sorted(before + after) == list(range(n))
    planned = _drain(mk(0, 1))
    loader = mk(0, 1)
    loader.quarantine([(0, 1), (0, 3)])
    got = _drain(loader)
    poisoned = set(planned[bs:2 * bs]) | set(planned[3 * bs:4 * bs])
    assert sorted(got) == sorted(set(planned) - poisoned)
    assert ttel.event_counts().get("batch_quarantined") == 2
    with pytest.raises(RuntimeError, match="seed="):
        DataLoader(_index_ds(tmx, 8), batch_size=4).state_dict()


@pytest.mark.parametrize("thread_pool", [True, False],
                         ids=["threads", "processes"])
def test_worker_errors_carry_context_and_leave_no_workers(thread_pool):
    before = set(threading.enumerate())
    loader = DataLoader(FailingDataset(), batch_size=4,
                        num_workers=1 if not thread_pool else 2,
                        thread_pool=thread_pool)
    it = iter(loader)
    assert len([next(it) for _ in range(3)]) == 3
    with pytest.raises(DataLoaderWorkerError) as exc:
        next(it)
    msg = str(exc.value)
    assert "batch 3" in msg and "13" in msg
    if not thread_pool:
        assert "worker traceback" in msg and "poisoned sample 13" in msg
    # an early break (here: an abandoned iterator) cleans up too
    it2 = iter(loader)
    next(it2)
    del it2
    import gc

    gc.collect()
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
    assert not [p for p in multiprocessing.active_children()
                if p.is_alive()]


@pytest.mark.parametrize("site", ["worker_hang", "data_skew"])
def test_data_fault_sites(faults, monkeypatch, site):
    monkeypatch.setenv("MXTPU_DATA_TIMEOUT", "0.3" if site == "worker_hang"
                       else "30")
    monkeypatch.setenv("MXTPU_DATA_HANG_SECS", "1.0")
    monkeypatch.setenv("MXTPU_DATA_SKEW_SECS", "0.02")
    faults(f"{site}:1")
    loader = DataLoader(_index_ds(tmx, 32), batch_size=8, seed=0,
                        num_workers=2)
    if site == "worker_hang":
        with pytest.raises(DataLoaderWorkerError, match="batch 1"):
            _drain(loader)
        assert ttel.event_counts().get("data_worker_timeout") == 1
    else:   # slow but alive: the watchdog stays quiet
        assert sorted(_drain(loader)) == list(range(32))
        assert not ttel.event_counts().get("data_worker_timeout")


class _NDSamples:
    """Samples made as NDArrays in the worker, on whatever context is
    current there."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return tmx.nd.array(np.full(2, i, np.float32))


def test_workers_run_under_the_callers_context():
    """A context is thread-local; a worker thread that read its own would
    see the default card (which raises here) inside ``with cpu():``."""
    for kw in (dict(num_workers=2), dict(num_workers=2, pin_memory=True)):
        got = list(DataLoader(_NDSamples(), batch_size=4, **kw))
        assert [b.context for b in got] == [cpu(), cpu()]
    got = list(DevicePrefetcher(DataLoader(_NDSamples(), batch_size=4,
                                           num_workers=2), depth=2))
    assert _vals(got[1]) == [4, 4, 5, 5, 6, 6, 7, 7]


# -- DevicePrefetcher ----------------------------------------------------------

def _gen_source():
    rng = np.random.RandomState(2)
    return [(rng.rand(3, 4).astype(np.float32),
             torch.from_numpy(rng.rand(3, 2).astype(np.float32))
             .to(torch.bfloat16), np.arange(3) + i) for i in range(4)]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("source", ["threads", "pinned", "generator",
                                    "ndarray_iter"])
def test_prefetcher_delivers_what_the_source_gives(source, depth):
    if source == "generator":
        items = _gen_source()
        got = list(DevicePrefetcher(iter(items), depth=depth))
        for g, (a, b, c) in zip(got, items):
            np.testing.assert_array_equal(g[0].asnumpy(), a)
            assert g[1]._data.dtype == torch.bfloat16
            assert torch.equal(g[1]._data, b)
            np.testing.assert_array_equal(g[2].asnumpy(), c)
        assert len(got) == 4
        return
    if source == "ndarray_iter":
        data = np.random.RandomState(0).rand(20, 3).astype(np.float32)
        for pkg, out in ((tmx, []), (jmx, [])):
            pf = pkg.gluon.data.DevicePrefetcher(
                pkg.io.NDArrayIter(data, np.zeros(20, np.float32), 6),
                depth=depth)
            for _ in range(2):   # two epochs through reset()
                pf.reset()
                out.append([(_np(b.data[0]), b.pad) for b in pf])
            if pkg is tmx:
                got = out
        for epoch, jepoch in zip(got, out):
            for (a, pa), (b, pb) in zip(epoch, jepoch):
                np.testing.assert_array_equal(a, b)
                assert pa == pb
        return
    kw = dict(batch_size=5, num_workers=2)
    if source == "pinned":
        kw["pin_memory"] = True
    want = list(jgluon.data.DevicePrefetcher(
        jgluon.data.DataLoader(PairDataset(), batch_size=5), depth=depth))
    got = list(DevicePrefetcher(DataLoader(PairDataset(), **kw),
                                depth=depth))
    _same(got, want)
    assert ttel.REGISTRY.snapshot()["input.batches"] == len(got)


def test_prefetch_env_zero_is_synchronous(monkeypatch):
    monkeypatch.setenv("MXTPU_DEVICE_PREFETCH", "0")
    loader = DataLoader(PairDataset(n=12), batch_size=4)
    pf = DevicePrefetcher(loader)
    assert pf._depth == 0
    got = []
    for b in pf:
        got.append(b)
        assert not [t for t in threading.enumerate()
                    if t.name == "mxtpu-device-prefetch"]
    _same(got, list(loader))
    assert pf._thread is None


def test_prefetcher_source_errors_and_early_break():
    def boom():
        yield np.zeros((2,), np.float32)
        raise RuntimeError("source exploded")

    it = iter(DevicePrefetcher(boom(), depth=2))
    next(it)
    with pytest.raises(RuntimeError, match="source exploded"):
        next(it)

    def endless():
        i = 0
        while True:
            yield np.full((2, 2), i, np.float32)
            i += 1

    pf = DevicePrefetcher(endless(), depth=2)
    it = iter(pf)
    np.testing.assert_array_equal(next(it).asnumpy(), np.zeros((2, 2)))
    next(it)
    pf.close()
    assert not [t for t in threading.enumerate()
                if t.name == "mxtpu-device-prefetch" and t.is_alive()]


def test_prefetcher_accounting_is_delivery_exact():
    n, bs = 48, 8
    mk = lambda: DataLoader(_index_ds(tmx, n), batch_size=bs,  # noqa
                            shuffle=True, seed=4)
    pf = DevicePrefetcher(mk(), depth=3)
    it = iter(pf)
    first = [v for _ in range(3) for v in _vals(next(it))]
    sd = pf.state_dict()
    assert sd["cursor"] == 24       # not 24 + what the producer holds
    pf.close()
    fresh = DevicePrefetcher(mk(), depth=3)
    fresh.load_state_dict(sd)
    rest = _drain(fresh)
    assert sorted(first + rest) == list(range(n))
    assert fresh.samples_seen == n and fresh.last_batch_id() == (0, 5)


def test_prefetcher_mesh_and_what_waits():
    from mxnet_tpu_torch.parallel import Mesh, data_parallel_mesh

    mesh = data_parallel_mesh(1)
    got = list(DevicePrefetcher(DataLoader(PairDataset(n=8), batch_size=4),
                                depth=2, mesh=mesh))
    assert got[0][0].context == cpu()
    # several devices of one process: the port runs one process a rank
    # (a rank mesh places each rank's rows: tests/test_torch_ranks2.py)
    two = Mesh(np.array([torch.device("cpu")] * 2, dtype=object), ("dp",))
    with pytest.raises(NotImplementedError, match="one process a rank"):
        DevicePrefetcher([], mesh=two)
    kv = object()
    assert DevicePrefetcher([], kvstore=kv, warm_pull={})._kvstore is kv


def test_h2d_prefetch_spans_reach_torch_profiler():
    """``profiler.annotate('h2d_prefetch')`` from the producer thread shows
    in a torch.profiler trace that records every thread."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch import profiler

    loader = DataLoader(PairDataset(n=8), batch_size=4)
    with profile(activities=[ProfilerActivity.CPU],
                 **profiler.all_threads()) as prof:
        list(DevicePrefetcher(loader, depth=2))
    names = [e.key for e in prof.key_averages()]
    assert "h2d_prefetch" in names
    profiler.set_state("run")
    with profiler.annotate("step"):
        pass
    profiler.set_state("stop")
    assert profiler.aggregates(reset=True)["step"]["count"] == 1


# -- vision --------------------------------------------------------------------

def _transform_cases(T):
    return [T.ToTensor(), T.Normalize(mean=[0.5, 0.4, 0.3],
                                      std=[0.2, 0.1, 0.3]),
            T.Cast("float16"), T.Resize(6), T.Resize(7, keep_ratio=True),
            T.Resize((5, 9)), T.CenterCrop(8), T.CropResize(2, 1, 6, 4),
            T.CropResize(2, 1, 6, 4, size=(3, 2)), T.RandomResizedCrop(6),
            T.RandomFlipLeftRight(), T.RandomFlipTopBottom(),
            T.RandomBrightness(0.3), T.RandomContrast(0.3),
            T.RandomSaturation(0.3), T.RandomHue(0.2),
            T.RandomColorJitter(0.2, 0.2, 0.2, 0.1), T.RandomLighting(0.1),
            T.Compose([T.Resize(8), T.ToTensor()])]


def test_vision_transforms_match_jax():
    pytest.importorskip("PIL")
    from mxnet_tpu.gluon.data.vision import transforms as JT

    from mxnet_tpu_torch.gluon.data.vision import transforms as TT

    img = np.random.RandomState(0).randint(0, 256, (10, 12, 3)) \
        .astype(np.uint8)
    for t, j in zip(_transform_cases(TT), _transform_cases(JT)):
        x = tmx.nd.array(img, dtype="uint8")
        jx = jmx.nd.array(img, dtype="uint8")
        if isinstance(t, (TT.Normalize,)):
            x, jx = TT.ToTensor()(x), JT.ToTensor()(jx)
        for seed in (0, 1):
            random.seed(seed)
            np.random.seed(seed)
            got = t(x)
            random.seed(seed)
            np.random.seed(seed)
            want = j(jx)
            assert got.dtype == want.dtype, type(t).__name__
            _same([got], [want])
        assert isinstance(t, tgluon.Block)


def _write_idx(path, magic, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", magic)
                + b"".join(struct.pack(">I", d) for d in arr.shape)
                + arr.tobytes())


def test_vision_datasets_match_jax(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    rng = np.random.RandomState(1)
    _write_idx(tmp_path / "train-images-idx3-ubyte", 2051,
               rng.randint(0, 256, (5, 28, 28)).astype(np.uint8))
    _write_idx(tmp_path / "train-labels-idx1-ubyte", 2049,
               rng.randint(0, 10, 5).astype(np.uint8))
    raw = np.concatenate([rng.randint(0, 10, (4, 1)),
                          rng.randint(0, 256, (4, 3072))], 1)
    cifar = tmp_path / "cifar"
    cifar.mkdir()
    for i in range(5):
        raw.astype(np.uint8).tofile(cifar / f"data_batch_{i + 1}.bin")
    folder = tmp_path / "folder"
    for c in ("cat", "dog"):
        (folder / c).mkdir(parents=True)
        for k in range(2):
            Image.fromarray(rng.randint(0, 256, (6, 5, 3)).astype(np.uint8)) \
                .save(folder / c / f"{k}.png")
    outs = []
    for pkg in (tmx, jmx):
        V = pkg.gluon.data.vision
        items = []
        for ds in (V.MNIST(str(tmp_path)), V.CIFAR10(str(cifar)),
                   V.ImageFolderDataset(str(folder))):
            items.append([(_np(ds[i][0]), ds[i][1]) for i in range(len(ds))])
        outs.append(items)
    for t, j in zip(*outs):
        assert len(t) == len(j) > 0
        for (a, la), (b, lb) in zip(t, j):
            np.testing.assert_array_equal(a, b)
            assert la == lb
    with pytest.raises(tmx.MXNetError, match="downloads nothing"):
        tgluon.data.vision.MNIST(str(tmp_path / "empty"))


# -- callbacks, the Trainer hook, the MNIST example ----------------------------

def test_callbacks(tmp_path, caplog, capsys):
    from mxnet_tpu_torch import callback

    metric = tmx.metric.Accuracy()
    metric.update([tmx.nd.array([1, 0])], [tmx.nd.array([[0, 1], [1, 0]])])
    speed = callback.Speedometer(batch_size=4, frequent=2)
    logm = callback.log_train_metric(2)
    bar = callback.ProgressBar(total=4)
    with caplog.at_level(logging.INFO):
        for n in range(5):
            p = callback.BatchEndParam(0, n, metric)
            speed(p)
            logm(p)
            bar(p)
    assert speed.last_speed is not None and speed.last_speed > 0
    assert "Speed" in caplog.text and "Train-accuracy" in caplog.text
    assert "100%" in capsys.readouterr().out
    arg = {"w": tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))}
    aux = {"m": tmx.nd.array(np.ones(3, np.float32))}
    callback.do_checkpoint(str(tmp_path / "net"), period=2)(1, None, arg,
                                                            aux)
    saved = jmx.nd.load(str(tmp_path / "net-0002.params"))
    assert sorted(saved) == ["arg:w", "aux:m"]
    np.testing.assert_array_equal(saved["arg:w"].asnumpy(),
                                  arg["w"].asnumpy())


def test_trainer_attach_data_pipeline_reports_batch_ids():
    net = tgluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=cpu())
    tr = tgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.1})
    loader = DataLoader(tgluon.data.ArrayDataset(
        np.ones((8, 3), np.float32), np.zeros((8, 2), np.float32)),
        batch_size=4, seed=1)
    pf = DevicePrefetcher(loader, depth=2)
    assert tr.attach_data_pipeline(pf) is tr and tr._batch_ids() is None
    mon = tmx.numerics.DivergenceMonitor()
    tr.divergence_monitor = mon
    for x, y in pf:
        with tmx.autograd.record():
            loss = tgluon.loss.L2Loss()(net(x), y)
        loss.backward()
        tr.step(4)
        assert tr._batch_ids() == [loader.last_batch_id()]
    assert tr._batch_ids() == [(0, 1)]


def test_mnist_example_loop_runs_on_the_port():
    """examples/train_mnist_gluon.py's loop with mxnet_tpu replaced by
    mxnet_tpu_torch, on its synthetic data: NDArrayIter, DevicePrefetcher,
    Speedometer, and an accuracy that rises."""
    from mxnet_tpu_torch.callback import BatchEndParam, Speedometer
    from mxnet_tpu_torch.gluon import nn

    rng = np.random.RandomState(0)
    centers = rng.uniform(-1, 1, (10, 784)).astype(np.float32)
    y = rng.randint(0, 10, 1024)
    x = centers[y] + rng.normal(0, 0.3, (1024, 784)).astype(np.float32)
    train = DevicePrefetcher(tmx.io.NDArrayIter(
        x, y.astype(np.float32), 128, shuffle=True))
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(64, activation="relu"), nn.Dense(10))
    net.initialize(init=tmx.init.Xavier(), ctx=cpu())
    net.hybridize()
    trainer = tgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9})
    loss_fn = tgluon.loss.SoftmaxCrossEntropyLoss()
    speedometer = Speedometer(128, frequent=4)
    accs = []
    for epoch in range(2):
        train.reset()
        metric = tmx.metric.Accuracy()
        for nbatch, batch in enumerate(train):
            xb, yb = batch.data[0], batch.label[0]
            with tmx.autograd.record():
                out = net(xb)
                loss = loss_fn(out, yb)
            loss.backward()
            trainer.step(128)
            metric.update([yb], [out])
            if not accs:
                accs.append(metric.get()[1])    # the untrained first batch
            speedometer(BatchEndParam(epoch, nbatch, metric))
        accs.append(metric.get()[1])
    assert accs[0] < 0.5 and accs[2] >= accs[1] > 0.9, accs
    assert speedometer.last_speed is not None


# -- the benches ---------------------------------------------------------------

def test_bench_input_pipeline_and_resnet_stall_shares_on_the_host():
    """The port benches' input-path fields at a tiny size: the JPEG
    pipeline (bench.py:2230-2308) and bench_resnet's stall shares
    (bench.py:2146-2199) on a stand-in step."""
    pytest.importorskip("PIL")
    from mxnet_tpu_torch.tools import bench_input_pipeline, bench_resnet

    res = bench_input_pipeline.run(n=16, batch=4, image=8, workers=2,
                                   device=cpu())
    assert res["metric"] == "input_pipeline_imgs_per_sec"
    assert res["value"] > 0 and res["legacy_ips"] > 0
    for k in ("stall_share_prefetch", "stall_share_sync"):
        assert 0.0 <= res[k] <= 1.0
    seen = []

    def step(x, y):
        seen.append((x._data.dtype, tuple(x.shape), y.context))
        return x._data.float().sum()

    y = torch.zeros(2)
    pf, sync = bench_resnet.stall_shares(step, y, batch=2, image=8,
                                         layout="NHWC", device="cpu",
                                         steps=2)
    assert 0.0 <= pf <= 1.0 and 0.0 <= sync <= 1.0
    assert seen == [(torch.bfloat16, (2, 8, 8, 3), cpu())] * 8


def test_record_file_dataset_under_thread_workers(tmp_path):
    """Worker threads share the dataset's one file handle: every record
    still arrives whole, in order (the reads hold a lock)."""
    from mxnet_tpu_torch import recordio

    path = str(tmp_path / "raw.rec")
    rows = np.random.RandomState(3).randint(0, 256, (96, 64)) \
        .astype(np.uint8)
    w = recordio.MXIndexedRecordIO(str(tmp_path / "raw.idx"), path, "w")
    for i, r in enumerate(rows):
        w.write_idx(i, recordio.pack((0, float(i), i, 0), r.tobytes()))
    w.close()
    ds = tgluon.data.RecordFileDataset(path).transform(
        lambda rec: np.frombuffer(recordio.unpack(rec)[1], np.uint8))
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)     # threads switch between seek and read
    try:
        for depth in (0, 2) * 8:
            got = list(DevicePrefetcher(DataLoader(ds, batch_size=8,
                                                   num_workers=4),
                                        depth=depth))
            np.testing.assert_array_equal(
                np.concatenate([b.asnumpy() for b in got]), rows)
    finally:
        sys.setswitchinterval(interval)
