"""The port's RecordIO, image and ``mx.io`` modules against the JAX
package's, on the CPU.

RecordIO files cross both ways byte for byte, and so do the headers and
image records; the corrupt-record modes (strict, skip, resync, the
injected corrupt record, the flaky open) behave alike.  The image
helpers, ``normalize_flip_batch_np``, the augmenters and ``ImageIter``,
and every ``mx.io`` iterator give bitwise equal batches for the same
numpy inputs and seeds (uint8 and float32: tolerance 0).  64-bit host
arrays arrive as 32-bit ones in both packages (the JAX package's x64
mode is off).
"""

import os
import random
import struct
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _native as tnative
from mxnet_tpu_torch import image as timage
from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch import resilience as tres
from mxnet_tpu_torch.context import cpu
from torch_one_thread import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _host():
    with cpu():
        yield


@pytest.fixture
def faults(monkeypatch):
    """Arm MXTPU_FAULT_INJECT for both packages, counters reset."""
    from mxnet_tpu import resilience as jres

    def arm(spec):
        monkeypatch.setenv("MXTPU_FAULT_INJECT", spec)
        jres.reset_faults()
        tres.reset_faults()

    yield arm
    monkeypatch.delenv("MXTPU_FAULT_INJECT", raising=False)
    jres.reset_faults()
    tres.reset_faults()


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _equal(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


MAGIC = struct.pack("<I", 0xced7230a)
#: payloads with the magic embedded (aligned, twice, unaligned, at the
#: end), empty and ragged lengths: every framing branch
PAYLOADS = [b"", b"a", b"abcd" * 3 + MAGIC + b"tail", MAGIC,
            b"xy" + MAGIC + b"z", b"0123" + MAGIC + b"4567" + MAGIC,
            bytes(range(256)) * 3, b"end" + MAGIC]


def _read_all(reader):
    out = []
    while True:
        rec = reader.read()
        if rec is None:
            return out
        out.append(rec)


def _write(mod, path, payloads, idx_path=None):
    w = mod.MXIndexedRecordIO(idx_path, path, "w") if idx_path \
        else mod.MXRecordIO(path, "w")
    for i, p in enumerate(payloads):
        if idx_path:
            w.write_idx(i, p)
        else:
            w.write(p)
    w.close()


@pytest.mark.parametrize("writer,reader", [(trec, jrec), (jrec, trec)],
                         ids=["port_to_jax", "jax_to_port"])
def test_recordio_files_cross_both_ways(tmp_path, writer, reader):
    a, b = str(tmp_path / "a.rec"), str(tmp_path / "b.rec")
    _write(writer, a, PAYLOADS)
    _write(reader, b, PAYLOADS)
    assert open(a, "rb").read() == open(b, "rb").read()
    r = reader.MXRecordIO(a, "r")
    assert _read_all(r) == PAYLOADS
    r.close()
    # indexed: the .idx sidecars match too, and random access agrees
    ia, ib = str(tmp_path / "a.idx"), str(tmp_path / "b.idx")
    _write(writer, a, PAYLOADS, ia)
    _write(reader, b, PAYLOADS, ib)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(ia).read() == open(ib).read()
    r = reader.MXIndexedRecordIO(ia, a, "r")
    for k in (5, 0, 7, 2):
        assert r.read_idx(k) == PAYLOADS[k]
    r.close()


def test_native_codec_reads_the_port_files(tmp_path):
    """src/libmxtpu_io.so (built by make -C src) scans and reads what the
    port writes; skips where the library is not built."""
    if not tnative.available():
        pytest.skip("src/libmxtpu_io.so not built (make -C src)")
    path = str(tmp_path / "n.rec")
    plain = [p for p in PAYLOADS if MAGIC not in p]
    _write(trec, path, plain)
    rd = tnative.NativeRecordReader(path)
    offs = rd.scan()
    assert [rd.read_at(o) for o in offs] == plain
    rd.close()


@pytest.mark.parametrize("label", [3.0, [1.0, 2.5, -4.0]],
                         ids=["scalar", "vector"])
def test_irheader_pack_unpack_matches(label):
    hdr = (0, label, 17, 5)
    got, want = trec.pack(hdr, b"payload"), jrec.pack(hdr, b"payload")
    assert got == want
    th, tp = trec.unpack(want)
    jh, jp = jrec.unpack(got)
    assert tp == jp == b"payload"
    assert (th.flag, th.id, th.id2) == (jh.flag, jh.id, jh.id2)
    np.testing.assert_array_equal(np.asarray(th.label),
                                  np.asarray(jh.label))


def test_pack_img_unpack_img_match():
    pytest.importorskip("PIL")
    img = np.random.RandomState(0).randint(0, 256, (12, 10, 3)) \
        .astype(np.uint8)
    hdr = jrec.IRHeader(0, 2.0, 1, 0)
    for fmt in (".png", ".jpg"):
        got = trec.pack_img(hdr, img, img_fmt=fmt)
        assert got == jrec.pack_img(hdr, img, img_fmt=fmt)
        _, t = trec.unpack_img(got)
        _, j = jrec.unpack_img(got)
        np.testing.assert_array_equal(t, j)


def _corrupt_file(tmp_path, kind):
    path = str(tmp_path / f"{kind}.rec")
    payloads = [bytes([65 + i]) * 32 for i in range(6)]
    _write(trec, path, payloads)
    blob = bytearray(open(path, "rb").read())
    if kind == "truncated":
        blob = blob[:-25]
    elif kind == "partial_header":
        blob += b"\x01\x02\x03\x04\x05"
    elif kind == "bad_magic":
        off = 2 * (8 + 32)
        blob[off:off + 4] = b"\xff\xff\xff\xff"
    open(path, "wb").write(bytes(blob))
    return path


def _outcome(mod, path, skip):
    r = mod.MXRecordIO(path, "r", skip_corrupt=skip)
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            got = _read_all(r)
        return got, [str(x.message).split(" in ")[0] for x in w]
    except Exception as e:  # noqa: BLE001 (compared across packages)
        return type(e).__name__, str(e).split(" in ")[0]
    finally:
        r.close()


@pytest.mark.parametrize("skip", [False, True], ids=["strict", "skip"])
@pytest.mark.parametrize("kind", ["truncated", "partial_header",
                                  "bad_magic", "injected"])
def test_corrupt_record_modes_match(tmp_path, faults, kind, skip):
    path = _corrupt_file(tmp_path, "clean" if kind == "injected" else kind)
    if kind == "injected":
        faults("corrupt_record:3")
    got = _outcome(trec, path, skip)
    if kind == "injected":
        faults("corrupt_record:3")
    want = _outcome(jrec, path, skip)
    assert got == want
    if skip:
        assert isinstance(got[0], list) and got[1]   # warned, then read on
    else:
        assert got[0] == "MXNetError"


def test_open_retries_a_flaky_filesystem_and_fails_fast_on_enoent(
        tmp_path, faults, monkeypatch):
    monkeypatch.setenv("MXTPU_IO_RETRIES", "3")
    monkeypatch.setenv("MXTPU_IO_BACKOFF", "0.001")
    path = str(tmp_path / "flaky.rec")
    _write(trec, path, [b"payload" * 4])
    faults("io_open:2")
    r = trec.MXRecordIO(path, "r")      # survives 2 injected failures
    assert r.read() == b"payload" * 4
    r.close()
    faults("io_open:9")
    with pytest.raises(tres.InjectedFault):
        trec.MXRecordIO(path, "r")
    faults("")
    with pytest.raises(FileNotFoundError):
        trec.MXRecordIO(str(tmp_path / "nope.rec"), "r")


# -- image ---------------------------------------------------------------------

def _img(seed=0, shape=(20, 28, 3)):
    return np.random.RandomState(seed).randint(0, 256, shape) \
        .astype(np.uint8)


def test_image_codec_and_geometry_match():
    pytest.importorskip("PIL")
    arr = _img()
    for fmt in (".png", ".jpg"):
        buf = timage.imencode(arr, img_fmt=fmt)
        assert buf == jimage.imencode(arr, img_fmt=fmt)
        for flag in (0, 1):
            np.testing.assert_array_equal(timage.imdecode_np(buf, flag),
                                          jimage.imdecode_np(buf, flag))
        _equal(timage.imdecode(buf), jimage.imdecode(buf))
    assert timage.imdecode(buf).context == cpu()
    for t, j in ((timage.imresize_np(arr, 13, 9),
                  jimage.imresize_np(arr, 13, 9)),
                 (timage.resize_short_np(arr, 12),
                  jimage.resize_short_np(arr, 12)),
                 (timage.center_crop_np(arr, (10, 8)),
                  jimage.center_crop_np(arr, (10, 8))),
                 (timage.fixed_crop_np(arr, 2, 3, 9, 7, size=(5, 5)),
                  jimage.fixed_crop_np(arr, 2, 3, 9, 7, size=(5, 5))),
                 (timage.imresize_np(arr.astype(np.float32), 7, 5),
                  jimage.imresize_np(arr.astype(np.float32), 7, 5))):
        np.testing.assert_array_equal(t, j)
    random.seed(4)
    t = timage.random_crop(arr, (9, 7))
    random.seed(4)
    j = jimage.random_crop(arr, (9, 7))
    _equal(t[0], j[0])
    assert t[1] == j[1]
    _equal(timage.color_normalize(arr, np.array([1.0, 2.0, 3.0]),
                                  np.array([2.0, 4.0, 8.0])),
           jimage.color_normalize(arr, np.array([1.0, 2.0, 3.0]),
                                  np.array([2.0, 4.0, 8.0])))


@pytest.mark.parametrize("mirror", [None, "mask"])
def test_normalize_flip_batch_np_bitwise(mirror):
    u8 = np.random.RandomState(1).randint(0, 256, (6, 9, 11, 3),
                                          dtype=np.uint8)
    m = None if mirror is None else np.array([1, 0, 1, 1, 0, 0], bool)
    mean = np.array([123.68, 116.28, 103.53], np.float32).reshape(3, 1, 1)
    std = np.array([58.395, 57.12, 57.375], np.float32).reshape(3, 1, 1)
    got = timage.normalize_flip_batch_np(u8.copy(), m, 1.0 / 255, mean, std)
    want = jimage.normalize_flip_batch_np(u8.copy(), m, 1.0 / 255, mean,
                                          std)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_augmenters_match():
    pytest.importorskip("PIL")
    arr = _img(2, (30, 26, 3))
    kw = dict(resize=24, rand_crop=True, rand_mirror=True, mean=True,
              std=True, brightness=0.3, contrast=0.3, saturation=0.3,
              hue=0.2, pca_noise=0.1, rand_gray=0.5)
    taugs = timage.CreateAugmenter((3, 16, 16), **kw)
    jaugs = jimage.CreateAugmenter((3, 16, 16), **kw)
    assert [type(a).__name__ for a in taugs] == \
        [type(a).__name__ for a in jaugs]
    assert taugs[0].dumps() == jaugs[0].dumps()
    for seed in range(3):
        outs = []
        for augs, mod in ((taugs, timage), (jaugs, jimage)):
            random.seed(seed)
            np.random.seed(seed)
            x = mod._to_nd(arr)
            for a in augs:
                x = a(x)
            outs.append(_np(x))
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-4)


def _image_rec(tmp_path, mod, n=6, size=(14, 18)):
    pytest.importorskip("PIL")
    path = str(tmp_path / "imgs.rec")
    w = mod.MXRecordIO(path, "w")
    for i in range(n):
        w.write(mod.pack_img(mod.IRHeader(0, float(i), i, 0),
                             _img(i, size + (3,)), img_fmt=".png"))
    w.close()
    return path


def test_image_iter_matches(tmp_path):
    rec = _image_rec(tmp_path, trec)
    outs = []
    for mod in (timage, jimage):
        random.seed(0)
        np.random.seed(0)
        it = mod.ImageIter(
            3, (3, 12, 12), path_imgrec=rec, shuffle=True,
            aug_list=mod.CreateAugmenter((3, 12, 12), rand_crop=True,
                                         rand_mirror=True, mean=True,
                                         std=True))
        outs.append([(_np(b.data[0]), _np(b.label[0])) for b in it])
    assert len(outs[0]) == len(outs[1]) == 2
    for (td, tl), (jd, jl) in zip(*outs):
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)


# -- mx.io ---------------------------------------------------------------------

def _batches(it):
    return [([_np(d) for d in b.data], [_np(l) for l in b.label], b.pad)
            for b in it]


def _same_batches(got, want):
    assert len(got) == len(want)
    for (td, tl, tp), (jd, jl, jp) in zip(got, want):
        assert tp == jp
        for a, b in zip(td + tl, jd + jl):
            _equal(a, b)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches(handle):
    data = np.random.RandomState(0).rand(11, 3, 2).astype(np.float32)
    label = np.arange(11)
    outs = []
    for mx in (tmx, jmx):
        np.random.seed(7)
        it = mx.io.NDArrayIter({"a": data, "b": data[:, :1]}, label, 4,
                               shuffle=True, last_batch_handle=handle)
        outs.append(_batches(it) + [None] + _batches((it.reset(), it)[1]))
        assert [tuple(d) for d in it.provide_data] == \
            [("a", (4, 3, 2)), ("b", (4, 1, 2))]
    _same_batches([o for o in outs[0] if o], [o for o in outs[1] if o])


def test_ndarray_iter_state_roundtrip_matches():
    data = np.arange(40, dtype=np.float32).reshape(20, 2)
    np.random.seed(3)
    it = tmx.io.NDArrayIter(data, np.arange(20), 3, shuffle=True)
    head = [it.next() for _ in range(2)]
    sd = it.state_dict()
    rest = _batches(it)
    it2 = tmx.io.NDArrayIter(data, np.arange(20), 3, shuffle=False)
    it2.load_state_dict(sd)
    _same_batches(_batches(it2), rest)
    seen = np.concatenate([_np(b.label[0]) for b in head]
                          + [r[1][0] for r in rest])
    assert sorted(seen[:20].tolist()) == list(range(20))
    np.random.seed(3)
    jit = jmx.io.NDArrayIter(data, np.arange(20), 3, shuffle=True)
    [jit.next() for _ in range(2)]
    assert jit.state_dict() == sd      # same order, same cursor
    with pytest.raises(ValueError):
        it2.load_state_dict({"version": 1, "cursor": 0, "idx": [0, 0]})


def test_resize_and_prefetching_iters_match():
    data = np.random.RandomState(1).rand(10, 3).astype(np.float32)
    outs = []
    for mx in (tmx, jmx):
        base = mx.io.NDArrayIter(data, np.arange(10), 4)
        rs = _batches(mx.io.ResizeIter(base, 5))
        a = mx.io.NDArrayIter(data, np.arange(10), 5)
        b = mx.io.NDArrayIter(data * 2, np.arange(10) + 1, 5)
        pre = mx.io.PrefetchingIter([a, b], rename_data=[{"data": "x"},
                                                         {"data": "y"}])
        names = [d.name for d in pre.provide_data]
        got = _batches(pre)
        pre.reset()
        outs.append((rs, got, _batches(pre), names))
    for t, j in zip(outs[0][:3], outs[1][:3]):
        _same_batches(t, j)
    assert outs[0][3] == outs[1][3] == ["x", "y"]


def test_prefetching_iter_threads_run_under_the_caller_context():
    """A context is thread-local: the prefetch threads must place on the
    context current where the iterator was built (here the host), never
    the default card."""
    pre = tmx.io.PrefetchingIter(tmx.io.NDArrayIter(
        np.zeros((4, 2), np.float32), np.zeros(4), 2))
    for b in pre:
        assert b.data[0].context == cpu()


def test_csv_mnist_libsvm_iters_match(tmp_path):
    rng = np.random.RandomState(2)
    data = rng.rand(9, 3).astype(np.float32)
    np.savetxt(tmp_path / "d.csv", data, delimiter=",")
    np.savetxt(tmp_path / "l.csv", np.arange(9.0), delimiter=",")
    imgs = rng.randint(0, 256, (7, 28, 28)).astype(np.uint8)
    labs = rng.randint(0, 10, 7).astype(np.uint8)
    with open(tmp_path / "img", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 7, 28, 28) + imgs.tobytes())
    with open(tmp_path / "lab", "wb") as f:
        f.write(struct.pack(">II", 2049, 7) + labs.tobytes())
    with open(tmp_path / "s.libsvm", "w") as f:
        f.write("1 0:1.5 3:2\n0 2:-1\n\n1 1:4 4:0.25\n")
    outs = []
    for mx in (tmx, jmx):
        np.random.seed(5)
        csv = mx.io.CSVIter(str(tmp_path / "d.csv"), (3,),
                            str(tmp_path / "l.csv"), batch_size=4)
        mn = mx.io.MNISTIter(str(tmp_path / "img"), str(tmp_path / "lab"),
                             batch_size=3, flat=True)
        svm = mx.io.LibSVMIter(str(tmp_path / "s.libsvm"), (5,),
                               batch_size=2, stype="default")
        outs.append([_batches(csv), _batches(mn), _batches(svm)])
    for t, j in zip(*outs):
        _same_batches(t, j)
    # the default stype: CSR batches, the same matrices as the dense ones
    csr = [b.data[0] for b in tmx.io.LibSVMIter(
        str(tmp_path / "s.libsvm"), (5,), batch_size=2)]
    assert all(c.stype == "csr" for c in csr)
    np.testing.assert_array_equal(
        np.concatenate([c.asnumpy() for c in csr]),
        np.concatenate([b[0][0] for b in outs[0][2]]))


def test_image_record_iter_matches(tmp_path, monkeypatch):
    """The pure-Python decode path of both packages (PNG records: the
    native JPEG path declines them), seeded mirror and crop draws."""
    rec = _image_rec(tmp_path, trec, n=5, size=(20, 22))
    outs = []
    for mx in (tmx, jmx):
        np.random.seed(1)
        random.seed(1)
        it = mx.io.ImageRecordIter(
            rec, (3, 16, 16), batch_size=2, shuffle=True, rand_crop=True,
            rand_mirror=True, mean_r=123.0, mean_g=117.0, mean_b=104.0,
            std_r=58.0, std_g=57.0, std_b=57.5, scale=1.0 / 255,
            resize=18)
        outs.append(_batches(it))
    _same_batches(*outs)
    assert len(outs[0]) == 3 and outs[0][-1][0][0].shape == (2, 3, 16, 16)
