"""The port's serving launcher (``python -m repro_torch.launch.serve``) on
the CPU (smoke config) and its byte tokenizer: the live stream, the plain
continuous run and the worker-thread drain give the same tokens; the paged
pool with packed prefill and a shared prefix gives the dense tokens with
prefix hits; what is not ported exits with an error."""

import numpy as np
import pytest

from repro_torch.data import ByteTokenizer
from repro_torch.launch.serve import main

BASE = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--requests", "5",
        "--batch", "2", "--max-new", "4", "--max-seq", "64"]


@pytest.fixture(scope="module")
def continuous():
    return main(BASE)


def _same_tokens(a, b):
    assert len(a["outputs"]) == len(b["outputs"])
    for x, y in zip(a["outputs"], b["outputs"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["--stream", "--emit-async"])
def test_stream_and_emit_async_give_the_continuous_tokens(continuous, mode, capsys):
    got = main(BASE + [mode])
    _same_tokens(got, continuous)
    out = capsys.readouterr().out
    assert "# stream: 5 requests" in out and "# slo: ttft_ms" in out
    assert got["stats"]["finish_reasons"] == continuous["stats"]["finish_reasons"]
    assert len(got["stats"]["ttft_ms"]) == 5


def test_paged_packed_shared_prefix_gives_the_dense_tokens(capsys):
    shared = ["--shared-prefix", "16"]
    dense = main(BASE + shared)
    paged = main(BASE + shared + ["--stream", "--kv-layout", "paged", "--packed-prefill",
                                  "--block-size", "8"])
    _same_tokens(paged, dense)
    assert paged["stats"]["prefix_hit_rate"] > 0 and paged["stats"]["packed_packs"] > 0
    out = capsys.readouterr().out
    assert "# paged: block_size=8" in out and "# packed: packs=" in out


@pytest.mark.parametrize("flags,needle", [(["--attn-backend", "xla"], "item 6"),
                                          (["--tp", "2"], "unrecognized arguments: --tp"),
                                          (["--warmup"], "unrecognized arguments: --warmup")])
def test_not_ported_flags_exit_with_an_error(flags, needle, capsys):
    with pytest.raises(SystemExit) as e:
        main(BASE + flags)
    assert e.value.code != 0 and needle in capsys.readouterr().err


def test_byte_tokenizer_round_trips_utf8():
    tok = ByteTokenizer()
    text = "posit ÷ SRT, 16 bits: ✓"
    ids = tok.encode(text, eos=True)
    assert ids[0] == tok.BOS and ids[-1] == tok.EOS and ids.dtype == np.int32
    assert int(ids.max()) < tok.vocab_size
    assert tok.decode(ids) == text
    assert tok.decode(tok.encode(text, bos=False)) == text
