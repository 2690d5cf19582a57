"""PyTorch port: the GPT BPE tokenizer, its pre-tokenizer and its native
merge engine, and ``tools/preprocess_data.py``, against the JAX package on
the CPU.

Vocabularies are built here (no GPT-2 files are in the repo): the
constructed byte-level vocab of tests/test_tokenizer.py:12, and a larger
one with a few hundred merges learned by a short BPE pass over a seeded
text.  Everything compared is exact: ids, decoded text, pieces, and the
preprocessed files byte for byte.
"""

import collections
import importlib.util
import json
import os
import random
import threading
import unicodedata

import numpy as np
import pytest
import regex
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from paddlefleetx_tpu.data.tokenizers import gpt_tokenizer as jax_tok
from paddlefleetx_tpu_torch.data import _build
from paddlefleetx_tpu_torch.data.tokenizers import gpt_tokenizer as pt_tok
from paddlefleetx_tpu_torch.data.tokenizers import unicode_classes
from paddlefleetx_tpu_torch.tools import gen_unicode_classes
from paddlefleetx_tpu_torch.tools import preprocess_data as pt_pre
from paddlefleetx_tpu_torch.utils.registry import TOKENIZERS

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = "<|endoftext|>"
SAMPLES = ["hello world", "hello", "a b  c\nd", "héllo ☂", "", "   ", "x  \n\n  y",
           "it's we've they'll I'm you'd don't", "123 4567 ½ ٣", "tab\there\x1cfs\x1fus",
           "日本語のテキスト", "emoji 🙂🙂 mixed👍🏽", "<|endoftext|>", "  leading", "trailing  "]


def _write_vocab(path, merges, extra=()):
    """The tests/test_tokenizer.py construction: the 256 byte symbols (id
    = byte), then the merged symbols, then ``extra`` and EOS."""
    b2u = jax_tok.bytes_to_unicode()
    symbols = [b2u[b] for b in range(256)] + [a + b for a, b in merges] + list(extra) + [EOS]
    vocab = {s: i for i, s in enumerate(dict.fromkeys(symbols))}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges))
    return str(path)


def _seeded_text(seed, n_words=3000):
    rnd = random.Random(seed)
    syl = ["th", "e", "an", "in", "er", "on", "re", "at", "st", "ou", "ing", "ch", "é", "ü"]
    words = []
    for _ in range(n_words):
        r = rnd.random()
        if r < 0.8:
            words.append("".join(rnd.choice(syl) for _ in range(rnd.randint(1, 4))))
        elif r < 0.9:
            words.append(str(rnd.randint(0, 9999)))
        else:
            words.append(rnd.choice([",", ".", "'s", "!", "\n", "  ", "—", "日本"]))
    return " ".join(words)


def _learn_merges(text, num_merges):
    """A short BPE pass: the most frequent adjacent pair (ties by the pair
    itself), merged everywhere, ``num_merges`` times."""
    b2u = jax_tok.bytes_to_unicode()
    words = collections.Counter(
        tuple(b2u[b] for b in w.encode("utf-8")) for w in pt_tok.pre_tokenize(text))
    merges = []
    for _ in range(num_merges):
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    return merges


@pytest.fixture(scope="module")
def vocab_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("vocab")
    small = _write_vocab(root / "small", [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o")])
    large = _write_vocab(root / "large", _learn_merges(_seeded_text(0), 300))
    return {"small": small, "large": large}


@pytest.fixture(scope="module")
def toks(vocab_dirs):
    return {name: (jax_tok.GPTTokenizer.from_pretrained(d), pt_tok.GPTTokenizer.from_pretrained(d))
            for name, d in vocab_dirs.items()}


def test_large_vocab_has_hundreds_of_merges(toks):
    _, tok = toks["large"]
    assert len(tok.bpe_ranks) == 300 and tok.vocab_size > 500
    assert tok.eos_token_id == tok.encoder[EOS] == tok.pad_token_id


@pytest.mark.parametrize("name", ["small", "large"])
def test_encode_decode_match_jax(toks, name):
    jt, pt = toks[name]
    for text in SAMPLES + [_seeded_text(1, 400)]:
        ids = pt.encode(text)
        assert ids == jt.encode(text), text
        assert pt.decode(ids) == jt.decode(ids) == text


@pytest.mark.parametrize("name", ["small", "large"])
def test_native_and_python_merge_loops_agree(toks, name):
    """Every word of the seeded text through the C++ engine and through
    the Python loop: the same ids (and the JAX Python loop's)."""
    jt, pt = toks[name]
    words = set(pt_tok.pre_tokenize(_seeded_text(2, 800) + " ".join(SAMPLES)))
    for w in words:
        raw = w.encode("utf-8")
        native = pt._native.encode_word(raw)
        assert native is not None
        mapped = "".join(jt.byte_encoder[b] for b in raw)
        assert native == pt._python_ids(raw) == [jt.encoder[t] for t in jt._bpe(mapped).split(" ")]


_FRAGMENTS = ["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "  ", " \n ", "\t\t", "   ",
              "\x1c\x1d", "\x1e \x1f", "　　x", "12 34", " 'S", "\r\n", " "]


def _post_unicode15():
    """Letters and numbers of regex's tables that Python's unicodedata
    (Unicode 15) does not know yet."""
    out = []
    for table in (unicode_classes.LETTER, unicode_classes.NUMBER):
        for a, b in table:
            out.extend(chr(c) for c in range(a, b + 1) if unicodedata.category(chr(c)) == "Cn")
    return out


_NEW_CHARS = _post_unicode15()
_CHARS = st.one_of(st.characters(exclude_categories=("Cs",)),
                   st.characters(max_codepoint=0x3000, exclude_categories=("Cs",)),
                   st.sampled_from(list(" \t\n\x0b\x0c\r\x1c\x1d\x1e\x1f\x85\xa0'sdtmlrev")
                                   + _NEW_CHARS[:2000]))
_TEXT = st.lists(st.one_of(st.text(alphabet=_CHARS, max_size=10), st.sampled_from(_FRAGMENTS)),
                 max_size=12).map("".join)


def test_there_are_post_unicode15_letters():
    # the case the committed table exists for: unicodedata would split these
    assert len(_NEW_CHARS) > 1000
    assert regex.fullmatch(r"\p{L}+", "".join(c for c in _NEW_CHARS[:50]
                                               if regex.match(r"\p{L}", c)))


@settings(max_examples=400, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(text=_TEXT)
def test_pre_tokenizer_matches_regex(text):
    assert pt_tok.pre_tokenize(text) == regex.findall(jax_tok._WORD_PAT, text)


@settings(max_examples=150, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow, HealthCheck.function_scoped_fixture])
@given(text=_TEXT)
def test_encode_matches_jax_on_any_text(toks, text):
    jt, pt = toks["large"]
    ids = pt.encode(text)
    assert ids == jt.encode(text)
    assert pt.decode(ids) == text


def test_pre_tokenizer_keeps_the_regex_spaces():
    # regex's \s leaves out U+001C-U+001F, which str.isspace() takes
    assert all("\x1c\x1d\x1e\x1f"[i].isspace() for i in range(4))
    text = "a\x1cb \x1f c  \n d"
    assert pt_tok.pre_tokenize(text) == regex.findall(jax_tok._WORD_PAT, text)
    assert pt_tok.pre_tokenize("a   b") == ["a", "  ", " b"]  # the \s+(?!\S) backtrack


def test_unicode_table_matches_regex():
    """The drift check: the committed table is what regex derives today."""
    table, version = gen_unicode_classes.derive()
    assert gen_unicode_classes.committed() == table, f"re-run the generator (regex {version})"
    assert [len(table[n]) for n, _ in gen_unicode_classes.CLASSES] == [684, 146, 10]


@pytest.mark.parametrize("word", ["x" * 4096, "x" * 5000, "é" * 2100, "ab" * 3000])
def test_long_words_take_the_python_loop(toks, word):
    jt, pt = toks["large"]
    text = f"start {word} end"
    raw = (" " + word).encode("utf-8")
    assert (pt._native.encode_word(raw) is None) == (len(raw) > 4096)
    ids = pt.encode(text)
    assert ids == jt.encode(text)
    assert pt.decode(ids) == text


def test_concurrent_encodes_match_single_threaded(vocab_dirs, monkeypatch):
    """The serve CLI encodes on its request threads: threads that encode
    distinct novel words at once each get the single-threaded ids, from the
    engine directly and through encode() with a cache that evicts on every
    insert."""
    monkeypatch.setattr(pt_tok, "_ENCODE_CACHE_MAX", 4)
    jt = jax_tok.GPTTokenizer.from_pretrained(vocab_dirs["large"])
    pt = pt_tok.GPTTokenizer.from_pretrained(vocab_dirs["large"])
    n_threads = 8
    texts = [_seeded_text(100 + k, 300) for k in range(n_threads)]
    want = [jt.encode(t) for t in texts]
    words = [sorted(set(pt_tok.pre_tokenize(t))) for t in texts]
    want_words = [[jt.encoder[t] for w in ws for t in
                   jt._bpe("".join(jt.byte_encoder[b] for b in w.encode("utf-8"))).split(" ")]
                  for ws in words]
    start = threading.Barrier(n_threads)
    got, errors = [None] * n_threads, []

    def run(k):
        try:
            start.wait()
            got[k] = ([[i for w in words[k] for i in pt._native.encode_word(w.encode("utf-8"))]
                       for _ in range(3)],
                      [pt.encode(texts[k]) for _ in range(3)])
        except Exception as e:  # reported below, with its thread
            errors.append((k, repr(e)))

    threads = [threading.Thread(target=run, args=(k,)) for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for k in range(n_threads):
        assert got[k] == ([want_words[k]] * 3, [want[k]] * 3)
    assert len(pt._id_cache) <= 4


def test_special_tokens(tmp_path):
    """EOS is its own id but encodes as plain text, as in JAX; a special
    token that is not byte-mappable stays out of the engine's vocab (a
    placeholder keeps the ids dense) without changing any id."""
    d = _write_vocab(tmp_path, [("h", "e")], extra=["<|sep☂|>"])
    jt, pt = jax_tok.GPTTokenizer.from_pretrained(d), pt_tok.GPTTokenizer.from_pretrained(d)
    assert pt.eos_token_id == jt.eos_token_id == pt.encoder[EOS]
    assert pt.decode([pt.eos_token_id]) == EOS
    for text in ("he <|endoftext|> he", "<|sep☂|>", "hehe☂"):
        assert pt.encode(text) == jt.encode(text)
    assert pt.encoder["<|sep☂|>"] == 257 and TOKENIZERS.get("GPTTokenizer") is pt_tok.GPTTokenizer


def test_failed_native_build_raises(tmp_path, monkeypatch, vocab_dirs):
    broken = tmp_path / "bpe.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BPE_SOURCE", broken)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="bpe.cpp build failed"):
        pt_tok.GPTTokenizer.from_pretrained(vocab_dirs["small"])
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises((RuntimeError, OSError)):
        pt_tok.GPTTokenizer.from_pretrained(vocab_dirs["small"])


def test_engine_builds_into_the_port_tree():
    path = _build.build(_build.BPE_SOURCE, "bpe")
    assert path.parent == _build.BUILD_ROOT / "bpe" and str(path).startswith(REPO)
    assert "paddlefleetx_tpu/" not in os.path.relpath(path, REPO)


def _jax_preprocess():
    spec = importlib.util.spec_from_file_location(
        "jax_preprocess_data", os.path.join(REPO, "tools", "preprocess_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,workers", [("small", 1), ("large", 1), ("large", 2)])
def test_preprocess_data_is_byte_identical(tmp_path, vocab_dirs, name, workers):
    lines = [json.dumps({"text": _seeded_text(s, 60 + 7 * s)}) for s in range(12)]
    lines[3] = json.dumps({"text": ""})  # skipped by both
    lines.insert(5, "")
    lines[7] = json.dumps({"text": "ends in eos" + EOS})
    src = tmp_path / "corpus.jsonl"
    src.write_text("\n".join(lines) + "\n")
    d = vocab_dirs[name]
    args = ["--input", str(src), "--tokenizer", "gpt", "--vocab_file", f"{d}/vocab.json",
            "--merges_file", f"{d}/merges.txt"]
    _jax_preprocess().main(args + ["--output_prefix", str(tmp_path / "jax" / "c")])
    assert pt_pre.main(args + ["--output_prefix", str(tmp_path / "pt" / "c"),
                               "--workers", str(workers)]) == 0
    for suffix in ("_ids.npy", "_idx.npz"):
        a = (tmp_path / "jax" / f"c{suffix}").read_bytes()
        b = (tmp_path / "pt" / f"c{suffix}").read_bytes()
        assert a == b, suffix
    lens = np.load(tmp_path / "pt" / "c_idx.npz")["lens"]
    assert len(lens) == 11 and np.load(tmp_path / "pt" / "c_ids.npy").dtype == np.uint16


@pytest.mark.parametrize("kind", ["t5", "ernie"])
def test_preprocess_refuses_unported_tokenizers(tmp_path, kind):
    src = tmp_path / "c.jsonl"
    src.write_text(json.dumps({"text": "x"}) + "\n")
    with pytest.raises(NotImplementedError, match="only the GPT tokenizer"):
        pt_pre.main(["--input", str(src), "--output_prefix", str(tmp_path / "o"),
                     "--tokenizer", kind, "--vocab_file", str(src)])
