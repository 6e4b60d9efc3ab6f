"""The port's host I/O against the JAX package's: the directory walk and its
decoder dispatch, the native WAV reader (its own build of its own copy of
csrc/wavio.cpp), the pitch tracker, the preprocessed and the paired
datasets, and the loader factory with `DatasetPreprocessed` sharded over
two ranks. Items are drawn with the same `np.random.default_rng(seed)` on
both sides and must be equal bit for bit."""

import struct

import numpy as np
import pytest

import hilcodec_tpu.data.datasets as JD
from hilcodec_tpu.data import native as jax_native
from hilcodec_tpu.data import pitch_np as jax_pitch
from hilcodec_tpu.data.loader import \
    get_dataset_dataloader as jax_get_dataset_dataloader
from hilcodec_tpu.utils.hparams import HParams as JaxHParams

import hilcodec_tpu_torch.data.datasets as TD
from hilcodec_tpu_torch.data import native, pitch_np
from hilcodec_tpu_torch.data.loader import get_dataset_dataloader
from hilcodec_tpu_torch.ops import cuda_build
from hilcodec_tpu_torch.utils import wavio
from hilcodec_tpu_torch.utils.hparams import HParams

SR = 24000


@pytest.fixture
def wav_tree(tmp_path):
    rng = np.random.default_rng(1234)
    for sub, n, length in (("clean", 3, 48000), ("noise", 2, 12000)):
        (tmp_path / sub).mkdir()
        for i in range(n):
            wavio.write_wav(str(tmp_path / sub / f"{sub}{i}.wav"),
                            rng.standard_normal(length) * 0.1, SR)
    return tmp_path


def _dirs_hp(cls, root):
    return cls(segment_size=SR, sampling_rate=SR, length=16, classes={
        "clean": {"directories_to_include": [str(root / "clean")],
                  "extension": "", "probability": 1.0}})


def test_non_wav_fails_fast_without_decoder(wav_tree):
    """tests/test_data.py::test_non_wav_fails_fast_without_decoder against
    the port: a .flac in the corpus fails construction with JAX's
    soundfile message, and reading or probing it raises the same."""
    flac = wav_tree / "clean" / "extra.flac"
    flac.write_bytes(b"fLaC....")
    assert TD._soundfile() is None
    with pytest.raises(RuntimeError, match="soundfile"):
        TD.DirectoriesDataset(_dirs_hp(HParams, wav_tree), ["wav"])
    with pytest.raises(RuntimeError, match="soundfile"):
        TD.read_wav(str(flac))
    with pytest.raises(RuntimeError, match="soundfile"):
        TD.wav_info(str(flac))
    assert str(TD._no_decoder_error("x")) == str(JD._no_decoder_error("x"))


def test_walk_collects_every_audio_extension_like_jax(wav_tree,
                                                      monkeypatch):
    """With a decoder present, both walks collect the .flac and .mp3 files
    beside the WAVs, in the same order."""
    for name in ("extra.flac", "more.mp3", "notes.txt"):
        (wav_tree / "clean" / name).write_bytes(b"....")
    stub = object()
    monkeypatch.setattr(TD, "_soundfile", lambda: stub)
    monkeypatch.setattr(JD, "_soundfile", lambda: stub)
    assert TD.AUDIO_EXT == JD.AUDIO_EXT
    ours = TD.Directories([str(wav_tree / "clean")]).files
    ref = JD.Directories([str(wav_tree / "clean")]).files
    assert ours == ref and len(ours) == 5


# -- the native reader ---------------------------------------------------------
@pytest.fixture
def wavs(tmp_path):
    rng = np.random.default_rng(7)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"w{i}.wav")
        wavio.write_wav(p, rng.standard_normal(24000 + i * 100) * 0.2, SR)
        paths.append(p)
    return paths


def test_native_info_matches_jax_and_stdlib(wavs):
    for p in wavs:
        assert native.wav_info(p) == jax_native.wav_info(p) \
            == wavio.wav_info(p)


@pytest.mark.parametrize("start,frames", [(0, -1), (1000, 320)])
def test_native_segment_matches_jax_and_stdlib(wavs, start, frames):
    ours = native.read_segment(wavs[0], start, frames)
    np.testing.assert_array_equal(
        ours, jax_native.read_segment(wavs[0], start, frames))
    ref, _ = wavio.read_wav(wavs[0], start,
                            None if frames < 0 else frames)
    np.testing.assert_array_equal(ours, ref)


def test_native_batch_and_short_read(wavs):
    out = native.read_batch(wavs, [0, 100, 200], 4800, threads=3)
    np.testing.assert_array_equal(
        out, jax_native.read_batch(wavs, [0, 100, 200], 4800, threads=3))
    for i, p in enumerate(wavs):
        np.testing.assert_array_equal(
            out[i], wavio.read_wav(p, start=i * 100, frames=4800)[0])
    n, _, _ = native.wav_info(wavs[0])
    short = native.read_batch([wavs[0]], [n - 100], 320)
    np.testing.assert_array_equal(
        short, jax_native.read_batch([wavs[0]], [n - 100], 320))
    assert np.all(short[0, 100:] == 0) and np.any(short[0, :100] != 0)


def test_read_wav_counts_native_reads(wavs):
    before = dict(TD.READS)
    data, sr = TD.read_wav(wavs[1], start=5, frames=64)
    ref, _ = JD.read_wav(wavs[1], start=5, frames=64)
    np.testing.assert_array_equal(data, ref)
    assert sr == SR and TD.READS["native"] == before["native"] + 1
    assert TD.READS["stdlib"] == before["stdlib"]


def _float64_wav(path, n=16):
    """A 64-bit IEEE float WAV, which the native reader refuses."""
    data = np.linspace(-0.5, 0.5, n).astype("<f8").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, SR, SR * 8, 8, 64)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", len(data)) + data)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


def test_file_the_native_reader_refuses_goes_to_stdlib(tmp_path):
    """As JAX's read_wav: a WAV the native reader cannot decode is read by
    the stdlib reader (which cannot either: the same error on both
    sides), file by file; this is not a build fallback."""
    p = str(tmp_path / "f64.wav")
    _float64_wav(p)
    with pytest.raises(native.Refused):
        native.read_segment(p)
    before = TD.READS["stdlib"]
    with pytest.raises(Exception) as ours:
        TD.read_wav(p)
    with pytest.raises(Exception) as ref:
        JD.read_wav(p)
    assert type(ours.value) is type(ref.value)
    assert str(ours.value) == str(ref.value)
    assert TD.READS["stdlib"] == before + 1


def test_native_build_failure_raises(tmp_path, monkeypatch, wavs):
    """A library that does not build raises from the reader and from the
    dataset's read_wav: nothing gives way to the stdlib reader."""
    (tmp_path / "wavio.cpp").write_text("#error this source does not build\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed for wavio.cpp"):
        native.read_segment(wavs[0])
    with pytest.raises(RuntimeError, match="failed for wavio.cpp"):
        TD.read_wav(wavs[0])
    with pytest.raises(RuntimeError, match="failed for wavio.cpp"):
        native.available()


def _unloadable(monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise OSError("cannot open shared object file")
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", refuse)


def _no_source(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path / "missing")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")


@pytest.mark.parametrize("fault", [_unloadable, _no_source],
                         ids=["load", "source"])
def test_native_library_fault_raises(tmp_path, monkeypatch, wavs, fault):
    """A library that cannot be loaded, or whose source is missing, raises
    an OSError from the reader, from read_wav and from wav_info: only a
    file the reader refuses (`native.Refused`) goes to the stdlib reader,
    and a fault of the library is not one."""
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    fault(monkeypatch, tmp_path)
    before = dict(TD.READS)
    for read in (native.read_segment, TD.read_wav, TD.wav_info):
        with pytest.raises(OSError) as e:
            read(wavs[0])
        assert not isinstance(e.value, native.Refused)
    assert TD.READS == before


# -- pitch ---------------------------------------------------------------------
def _voiced_signal(seed=3, n=SR // 2):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = 140.0 + 60.0 * t
    wav = 0.4 * np.sin(2 * np.pi * np.cumsum(f0) / SR)
    wav[n // 3:n // 2] = 0.0                   # an unvoiced stretch
    return (wav + 0.01 * rng.standard_normal(n)).astype(np.float32)


def test_pitch_np_equals_jax():
    wav = _voiced_signal()
    ours = pitch_np.pitch_np(wav, SR, 300)
    np.testing.assert_array_equal(ours, jax_pitch.pitch_np(wav, SR, 300))
    assert (ours > 0).any() and (ours == 0).any()


@pytest.mark.parametrize("log_pitch", [False, True])
def test_extract_pitch_equals_jax(log_pitch):
    wav = _voiced_signal(4)
    p, v = TD.extract_pitch(wav, SR, 300, log_pitch=log_pitch)
    pj, vj = JD.extract_pitch(wav, SR, 300, log_pitch=log_pitch)
    np.testing.assert_array_equal(p, pj)
    np.testing.assert_array_equal(v, vj)
    assert p.dtype == np.float32 and len(p) == len(wav) // 300 + 1


# -- preprocessed and paired sets ------------------------------------------------
@pytest.fixture
def preprocessed(tmp_path):
    """Five dumped items of different lengths (two shorter than the
    segment) with their pitch tracks, and a train filelist."""
    rng = np.random.default_rng(11)
    data = tmp_path / "feats"
    data.mkdir()
    names = []
    for i, n in enumerate((9000, 5000, 12000, 3000, 7000)):
        wav = (rng.standard_normal(n) * 0.2).astype(np.float32)
        np.save(data / f"u{i}_wav.npy", wav)
        np.save(data / f"u{i}_pitch.npy",
                TD.extract_pitch(wav, SR, 300)[0])
        names.append(f"u{i}")
    (tmp_path / "train.txt").write_text("\n".join(names) + "\n")
    return tmp_path


def _pre_cfg(cls, root):
    return cls(
        data={"dataset": "DatasetPreprocessed", "data_dir":
              str(root / "feats"), "sampling_rate": SR,
              "segment_size": 4000, "filelists": {"train":
                                                  str(root / "train.txt")}},
        train={"batch_size": 2, "num_workers": 0, "seed": 5})


@pytest.mark.parametrize("keys", [["wav"], ["wav", "pitch", "filename"]])
def test_preprocessed_items_equal_jax(preprocessed, keys):
    hp_t = _pre_cfg(HParams, preprocessed).data
    hp_j = _pre_cfg(JaxHParams, preprocessed).data
    ours = TD.PreprocessedDataset(hp_t, keys, mode="train")
    ref = JD.PreprocessedDataset(hp_j, keys, mode="train")
    assert len(ours) == len(ref) == 5
    for i in range(5):
        a = ours.__getitem__(i, rng=np.random.default_rng(i))
        b = ref.__getitem__(i, rng=np.random.default_rng(i))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["wav"].shape == (4000,)


def test_loader_factory_preprocessed_two_shards_equal_jax(preprocessed):
    """get_dataset_dataloader with DatasetPreprocessed, sharded over two
    ranks: every batch of every shard equals JAX's, over two epochs."""
    for shard in (0, 1):
        _, ours = get_dataset_dataloader(_pre_cfg(HParams, preprocessed),
                                         "train", ["wav", "pitch"],
                                         num_shards=2, shard=shard)
        _, ref = jax_get_dataset_dataloader(
            _pre_cfg(JaxHParams, preprocessed), "train", ["wav", "pitch"],
            num_shards=2, shard=shard)
        assert len(ours) == len(ref) == 2
        for _epoch in range(2):
            for a, b in zip(ours, ref):
                for k in ("wav", "pitch"):
                    np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("segment", [4000, 20000, None])
def test_paired_items_equal_jax(tmp_path, segment):
    """The same start in the clean and the noisy file; a file shorter than
    the segment is centre-padded; segment None (infer) reads it whole."""
    rng = np.random.default_rng(2)
    for sub in ("clean", "noisy"):
        (tmp_path / sub).mkdir()
    for i, n in enumerate((15000, 9000)):
        for sub in ("clean", "noisy"):
            wavio.write_wav(str(tmp_path / sub / f"f{i}.wav"),
                            rng.standard_normal(n) * 0.1, SR)
    (tmp_path / "train.txt").write_text("f0.wav\nf1.wav\n")
    kw = dict(clean_dir=str(tmp_path / "clean"),
              noisy_dir=str(tmp_path / "noisy"), sampling_rate=SR,
              segment_size=segment,
              filelists={"train": str(tmp_path / "train.txt")})
    ours = TD.PairedCleanNoisyDataset(HParams(**kw),
                                      ["clean", "noisy", "filename"])
    ref = JD.PairedCleanNoisyDataset(JaxHParams(**kw),
                                     ["clean", "noisy", "filename"])
    ours.shuffle(3)
    ref.shuffle(3)
    assert ours.files == ref.files
    for i in range(2):
        a = ours.__getitem__(i, rng=np.random.default_rng(10 + i))
        b = ref.__getitem__(i, rng=np.random.default_rng(10 + i))
        assert a["filename"] == b["filename"]
        for k in ("clean", "noisy"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if segment is not None:
            assert a["clean"].shape == (segment,)
