"""BEAT preprocessing in the port against the JAX package: the native
float parser, TextGrid, Vocab, ``load_wav``, the numpy stratified split
against sklearn's ``train_test_split``, and ``prep`` end to end on a toy
corpus written here (2-joint BVHs of 30 s at 120 fps, int16 wavs, word
TextGrids, facial JSON), whose pickles must equal the JAX package's array
for array.  The last test runs the port's ``prep`` with sklearn,
matplotlib and PIL blocked, as on a machine that has none of them."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from sklearn.model_selection import train_test_split

from gesture_diffusion_tpu import native as jax_native
from gesture_diffusion_tpu.data import beat as jax_beat
from gesture_diffusion_tpu.data import textgrid as jax_textgrid
from gesture_diffusion_tpu.data import vocab as jax_vocab
from gesture_diffusion_torch import native
from gesture_diffusion_torch.data import beat, textgrid, vocab
from gesture_diffusion_torch.data.bvh import parse_bvh
from gesture_diffusion_torch.ops import kernel_build
from torch_port_common import textgrid_text, write_toy_recording

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = ("train", "val", "test")


# -- the native float parser ---------------------------------------------------

def _random_floats():
    rng = np.random.default_rng(0)
    vals = rng.normal(size=513) * 10.0 ** rng.integers(-8, 8, size=513)
    return " ".join(repr(float(v)) for v in vals) + "\n"


PARSE_CASES = {
    "repr-str": (_random_floats(), None),
    "repr-bytes": (_random_floats().encode(), 513),
    "stops-at-token": ("  1.5\n-2e3\t+.25 1e-300 Xrot 9 ", 99),
    "empty": ("", 10),
    "bounded": ("1 2 3 4 5", 3),
    "default-count": ("3.25 -1.5 0.125 7e2", None),
    "bvh-rows": (" ".join(f"{v:.4f}" for v in np.random.default_rng(1).uniform(
        -180, 180, 900)) + "\r\n", 900),
}


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_native_parser_matches_numpy_and_jax(case):
    text, expected = PARSE_CASES[case]
    ours = native.parse_floats(text, expected)
    plain = native.parse_floats_plain(text, expected)
    ref = jax_native.parse_floats(text, expected)
    assert ours.dtype == plain.dtype == np.float64
    np.testing.assert_array_equal(ours, plain)
    np.testing.assert_array_equal(ours, ref)
    if case == "stops-at-token":
        np.testing.assert_array_equal(ours, [1.5, -2000.0, 0.25, 1e-300])


def test_native_parser_is_built_from_the_repo_into_build_host():
    native.parse_floats("1 2", 2)
    path = kernel_build.BUILD_INFO["fast_parse"][0]
    assert path.parent == kernel_build.HOST_BUILD_DIR
    assert kernel_build.HOST_BUILD_DIR == kernel_build.BUILD_DIR.parent / "host"
    assert os.path.dirname(str(kernel_build.HOST_BUILD_DIR)) == os.path.join(REPO, "build")
    assert path.name.startswith("libfast_parse-") and path.suffix == ".so"


def test_native_parser_build_failure_raises(tmp_path, monkeypatch):
    """No numpy fallback: a failing or missing g++ raises, and so does the
    BVH parse that needs the parser."""
    (tmp_path / "fast_parse.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(kernel_build, "CSRC", tmp_path)
    monkeypatch.setattr(kernel_build, "HOST_BUILD_DIR", tmp_path / "host")
    with pytest.raises(RuntimeError, match="g.. failed on"):
        kernel_build.build_host_library("fast_parse")
    native._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g.. failed on"):
            parse_bvh(os.path.join(REPO, "tests", "golden", "synth_fullbody.bvh"))
        monkeypatch.setattr(kernel_build.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            native.parse_floats("1 2", 2)
    finally:
        native._library.cache_clear()
    assert not list((tmp_path / "host").glob("*.so"))


# -- TextGrid, Vocab, load_wav -------------------------------------------------

TG = textgrid_text([(6.0, 7.5, "héllo"), (7.5, 9.0, 'say ""hi""'), (9.0, 10.0, "world")], 30.0)
TG_BYTES = {
    "utf-8": TG.encode("utf-8"),
    "utf-8-sig": b"\xef\xbb\xbf" + TG.encode("utf-8"),
    "utf-16-le": b"\xff\xfe" + TG.encode("utf-16-le"),
    "utf-16-be": b"\xfe\xff" + TG.encode("utf-16-be"),
    "utf-16-truncated": (b"\xff\xfe" + TG.encode("utf-16-le"))[:-1],
    "utf-32-le": b"\xff\xfe\x00\x00" + TG.encode("utf-32-le"),
    "utf-32-be": b"\x00\x00\xfe\xff" + TG.encode("utf-32-be"),
    "garbage": b"\x80\x81 item [1]: intervals [1]: xmin = 1 xmax = 2 text = \"a\"",
}


@pytest.mark.parametrize("enc", sorted(TG_BYTES))
def test_read_textgrid_matches_jax(tmp_path, enc):
    p = tmp_path / f"{enc}.TextGrid"
    p.write_bytes(TG_BYTES[enc])
    ours, ref = textgrid.read_textgrid(str(p)), jax_textgrid.read_textgrid(str(p))
    assert [[tuple(iv) for iv in tier] for tier in ours] == \
        [[tuple(iv) for iv in tier] for tier in ref]
    if enc != "garbage":
        assert [iv.mark for iv in ours[0]][1:4] == ["héllo", 'say "hi"', "world"]


def _vocab_state(v):
    return (v.name, v.word2index, v.index2word, v.n_words,
            getattr(v, "_pretrained_path", None), getattr(v, "_dim", None))


def test_vocab_matches_jax(tmp_path):
    vec = np.full(4, 7.0, np.float32)
    np.savez(tmp_path / "v.npz", hello=vec)
    np.save(tmp_path / "v.npy", {"world": vec}, allow_pickle=True)
    np.save(tmp_path / "plain.npy", np.zeros((5, 4), np.float32))
    for path in (None, "v.npz", "v.npy"):
        full = None if path is None else str(tmp_path / path)
        ours, ref = vocab.Vocab("word"), jax_vocab.Vocab("word")
        for v in (ours, ref):
            for w in ("hello", "world", "hello", "beat"):
                v.index_word(w)
            v.load_word_vectors(full, dim=4)
        assert _vocab_state(ours) == _vocab_state(ref)
        assert [ours.get_word_index(w) for w in ("beat", "nope")] == \
            [ref.get_word_index(w) for w in ("beat", "nope")] == [6, vocab.UNK_token]
        np.testing.assert_array_equal(
            ours.build_embedding_table(np.random.default_rng(0)),
            ref.build_embedding_table(np.random.default_rng(0)))
    ours = vocab.Vocab("word")
    ours.index_word("hi")
    ours.load_word_vectors(str(tmp_path / "plain.npy"), dim=4)
    with pytest.raises(ValueError, match="expected an .npz"):
        ours.build_embedding_table(np.random.default_rng(0))


@pytest.mark.parametrize("sr", [8000, 48000])
@pytest.mark.parametrize("dtype", ["uint8", "int16"])
def test_load_wav_matches_jax(tmp_path, sr, dtype):
    from scipy.io import wavfile

    rng = np.random.default_rng(sr)
    if dtype == "int16":
        data = np.concatenate([[-32768, 32767, 0], rng.integers(-32768, 32767, sr)])
    else:
        data = np.concatenate([[0, 255, 128], rng.integers(0, 256, sr)])
    path = str(tmp_path / "a.wav")
    wavfile.write(path, sr, data.astype(dtype))
    ours = beat.load_wav(path, 16000)
    ref = jax_beat.load_wav(path, 16000)
    assert ours.dtype == np.float32 and ours.shape == (16000 + 3 * 16000 // sr,)
    np.testing.assert_array_equal(ours, ref)


# -- the stratified split against sklearn --------------------------------------

def _sklearn_split(idx, test_size, hid, seed):
    return train_test_split(idx, test_size=test_size, shuffle=True,
                            stratify=hid, random_state=seed)


def _hold_split(hid, seed=0, test_size=0.2):
    hid = np.asarray(hid)
    idx = np.arange(len(hid)) + 100
    try:
        ref = _sklearn_split(idx, test_size, hid, seed)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            beat.stratified_train_test_split(idx, test_size, hid, seed)
        assert str(ours.value) == str(e)
        return None
    ours = beat.stratified_train_test_split(idx, test_size, hid, seed)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    return ours


@pytest.mark.parametrize("name,hid", [
    ("one speaker, n 10", [1] * 10),
    ("one speaker, n 24", [1] * 24),
    ("one speaker, n 37", [1] * 37),
    ("three speakers, unequal", [2] * 20 + [5] * 7 + [11] * 5),
    ("three speakers, interleaved", [3, 1, 2] * 9 + [1] * 4),
    ("tied counts", [4] * 6 + [1] * 6 + [9] * 6),
    ("float hids", [1.0] * 8 + [2.0] * 4),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_stratified_split_matches_sklearn(name, hid, seed):
    """Both stages of the 8:1:1 split, as ``_stratified_split_and_save``
    makes them: the indices and their order."""
    hid = np.asarray(hid)
    train_rest = _hold_split(hid, seed)
    assert train_rest is not None
    rest = train_rest[1] - 100
    _hold_split(hid[rest], seed, 0.5)


@pytest.mark.parametrize("hid,test_size", [
    ([1] * 6 + [2], 0.2),                      # a class of one member
    ([1, 1, 2, 2, 3, 3, 4, 4, 5, 5], 0.2),     # fewer test rows than classes
    ([1, 1, 2, 2, 3, 3], 0.8),
    ([1, 1, 2, 2], 0.9),                       # fewer train rows than classes
    ([1], 0.5),                                # an empty train set
    ([1, 1, 1], 1.5),
    ([1, 1, 1], 0.0),
])
def test_stratified_split_errors_match_sklearn(hid, test_size):
    assert _hold_split(hid, 0, test_size) is None


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.integers(2, 40), min_size=1, max_size=6).filter(
    lambda counts: 4 <= sum(counts) <= 200),
    st.integers(0, 2 ** 32 - 1), st.integers(0, 2 ** 31 - 1))
def test_stratified_split_matches_sklearn_on_random_hids(counts, order, seed):
    """Random hid vectors of 4-200 entries in a random order, every class
    of 2 or more: the indices and order of both stages, or the same
    error."""
    hid = np.random.default_rng(order).permutation(np.repeat(
        np.arange(len(counts)) * 3 + 1, counts))
    out = _hold_split(hid, seed)
    if out is not None:
        _hold_split(hid[out[1] - 100], seed, 0.5)


# -- prep end to end -------------------------------------------------------------

def _corpus(root, face=False):
    """Speaker 1: 10 recordings of 30 s (one named with a begin-time
    offset), the unsyncable one, one without a TextGrid; speaker 2: 4
    recordings, its wav at 48 kHz."""
    for hid in (1, 2):
        os.makedirs(root / str(hid))
    names = [f"1_wayne_0_{i}_{i}" for i in range(20, 29)] + ["1_wayne_0_9_16"]
    for i, name in enumerate(names):
        write_toy_recording(root / "1", name, seed=i, face=face)
    write_toy_recording(root / "1", "1_wayne_1_1_2", seed=50, face=face)
    write_toy_recording(root / "1", "1_wayne_0_30_30", seed=51, face=face,
                        textgrid=False)
    for i in range(4):
        write_toy_recording(root / "2", f"2_scott_0_{i}_{i}", seed=60 + i,
                            wav_sr=48000, face=face)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("beat") / "BEAT"
    _corpus(root, face=True)
    return root


def _load_split(spt, split):
    with open(os.path.join(spt, f"{split}_samples.pkl"), "rb") as f:
        return pickle.load(f)


def _hold_pickles(ours, ref, splits=SPLITS, counts=None):
    for split in splits:
        a, b = _load_split(ours, split), _load_split(ref, split)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, (split, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{split}/{k}")
        if counts is not None:
            assert len(a["hid"]) == counts[split]
    with open(os.path.join(ours, "vocab.pkl"), "rb") as f:
        v = pickle.load(f)
    with open(os.path.join(ref, "vocab.pkl"), "rb") as f:
        r = pickle.load(f)
    assert type(v) is vocab.Vocab and type(r) is jax_vocab.Vocab
    assert _vocab_state(v) == _vocab_state(r) and v.n_words > 8
    with open(os.path.join(ours, "split_dataset.log")) as f:
        log = f.read()
    with open(os.path.join(ref, "split_dataset.log")) as f:
        # the port logs the unsyncable recording it skips; JAX skips silently
        assert "".join(line for line in log.splitlines(True)
                       if "Skipped (unsyncable)" not in line) == f.read()
    return log


def test_prep_matches_jax(corpus, tmp_path, capsys):
    """``preprocess_data`` (stratified by speaker, 2 speakers, 14 usable
    recordings of 2 samples each): the pickles, vocab and log."""
    kw = dict(src_dir_path=str(corpus), human_ids=[1, 2], pose_fps=20,
              wav_sr=16000, sample_duration=10.0, joints=["Spine"])
    beat.preprocess_data(spt_dir_path=str(tmp_path / "ours"), **kw)
    printed = capsys.readouterr().out
    jax_beat.preprocess_data(spt_dir_path=str(tmp_path / "ref"), **kw)
    log = _hold_pickles(str(tmp_path / "ours"), str(tmp_path / "ref"),
                        counts={"train": 22, "val": 3, "test": 3})
    assert log.count("[Info] Processed") == 14
    assert "TextGrid file not found" in printed and "1_wayne_0_30_30" in log
    assert "[Info] Skipped (unsyncable): " in printed
    assert [line for line in log.splitlines() if "1_wayne_1_1_2" in line] == [
        f"[Info] Skipped (unsyncable): {corpus / '1' / '1_wayne_1_1_2.bvh'}"]
    train = _load_split(str(tmp_path / "ours"), "train")
    assert train["pose"].shape == (22, 200, 3) and train["wav"].shape == (22, 160000)
    assert train["word_id"].shape == (22, 200) and train["word_id"].max() > 3
    assert set(np.unique(train["hid"])) == {1, 2}


def test_prep_with_face_matches_jax(corpus, tmp_path):
    kw = dict(src_dir_path=str(corpus), human_ids=[1], wav_sr=16000,
              sample_duration=10.0, pose_fps=20, joints=["Hips", "Spine"],
              use_face=True, face_fps=15, seed=3)
    beat.split_dataset(spt_dir_path=str(tmp_path / "ours"), **kw)
    jax_beat.split_dataset(spt_dir_path=str(tmp_path / "ref"), **kw)
    _hold_pickles(str(tmp_path / "ours"), str(tmp_path / "ref"))
    test = _load_split(str(tmp_path / "ours"), "test")
    assert test["face"].shape[1:] == (150, 4) and test["pose"].shape[1:] == (200, 6)


def test_official_split_matches_jax(tmp_path):
    """Recordings routed by their file names: sequence 1 and conversation
    1 to test, 56 and 12 to val, the rest to train; an odd name fails and
    is logged."""
    src = tmp_path / "BEAT" / "1"
    os.makedirs(src)
    for i, name in enumerate(["1_wayne_0_1_1", "1_wayne_0_56_56", "1_wayne_0_9_9",
                              "1_wayne_1_1_1", "1_wayne_1_12_12", "1_wayne_1_3_3",
                              "1_wayne_0_5_6"]):
        write_toy_recording(src, name, seed=i, seconds=25)
    kw = dict(src_dir_path=str(tmp_path / "BEAT"), human_ids=[1], wav_sr=16000,
              sample_duration=10.0, pose_fps=20, joints=["Spine"])
    beat.split_dataset_official(spt_dir_path=str(tmp_path / "ours"), **kw)
    jax_beat.split_dataset_official(spt_dir_path=str(tmp_path / "ref"), **kw)
    log = _hold_pickles(str(tmp_path / "ours"), str(tmp_path / "ref"),
                        counts={"train": 4, "val": 4, "test": 4})
    assert "last two numbers" in log
    with pytest.raises(NotImplementedError, match="4-hour"):
        beat.split_dataset_official(spt_dir_path=str(tmp_path / "x"),
                                    **{**kw, "human_ids": [5]})


def test_empty_corpus_and_refusals_match_jax(tmp_path):
    src = tmp_path / "BEAT" / "1"
    os.makedirs(src)
    write_toy_recording(src, "1_wayne_0_1_1", seed=0, textgrid=False)
    for pkg in (beat, jax_beat):
        with pytest.raises(ValueError, match="no samples collected"):
            pkg.split_dataset(str(tmp_path / "BEAT"), [1], 16000, 10.0,
                              str(tmp_path / pkg.__name__), pose_fps=20,
                              joints=["Spine"])
    with pytest.raises(FileNotFoundError, match="Source data not found"):
        beat.preprocess_data(str(tmp_path / "nope"), [1], 20, 16000, 10.0,
                             str(tmp_path / "spt"))
    with pytest.raises(FileExistsError, match="already exists"):
        beat.preprocess_data(str(tmp_path / "BEAT"), [1], 20, 16000, 10.0,
                             str(tmp_path / beat.__name__))


def test_prep_runs_without_sklearn_matplotlib_pil(tmp_path):
    """The port's CLI prep in a process where sklearn, matplotlib, PIL,
    JAX and the JAX package cannot be imported; its pickles equal the JAX
    package's."""
    import json

    root = tmp_path / "BEAT"
    os.makedirs(root / "1")
    for i in range(5):
        write_toy_recording(root / "1", f"1_wayne_0_{i}_{i}", seed=i)
    with open(os.path.join(REPO, "configs", "beat-ours.json")) as f:
        raw = json.load(f)
    raw["Data"].update({"src_dir_path": str(root), "joints": ["Spine"],
                        "sample_duration": 10.0,
                        "spt_dir_path": str(tmp_path / "spt"),
                        "hierarchy_path": str(tmp_path / "spt" / "hierarchy_upper.txt")})
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(raw))
    blocked = ("sklearn", "matplotlib", "PIL", "jax", "flax", "gesture_diffusion_tpu")
    # a finder that refuses them, as on a machine where they are not
    # installed (scipy looks jax up in sys.modules, so None there would not do)
    code = ("import sys\n"
            "class Absent:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            f"        if name.split('.')[0] in {blocked!r}:\n"
            "            raise ModuleNotFoundError(name)\n"
            "sys.meta_path.insert(0, Absent())\n"
            "from gesture_diffusion_torch import cli\n"
            f"cli.main(['--phase', 'prep', '--config', {str(cfg)!r}, '--device', 'cpu'])\n"
            f"assert not any(k.split('.')[0] in {blocked!r} for k in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Hierarchy template derived" in proc.stdout
    jax_beat.preprocess_data(str(root), [1], 20, 16000, 10.0, str(tmp_path / "ref"),
                             joints=["Spine"])
    _hold_pickles(str(tmp_path / "spt"), str(tmp_path / "ref"),
                  counts={"train": 8, "val": 1, "test": 1})
    hier = parse_bvh(str(tmp_path / "spt" / "hierarchy_upper.txt"))
    assert list(hier.joints) == ["Hips", "Spine", "Spine_Nub"]
