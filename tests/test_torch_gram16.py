"""The bf16 Gram's padding of R and the dipCN mode query, on the CPU.

``csrc/zprep_gram16.cu`` reads P in rows padded to one k16 step: checked
here through ``_r_pad``. ``dipcn_select_mode`` asks the card once per
width, k, card and dtype: checked here with a stand-in for the library.
The kernels themselves run only on the card (``tests/test_torch_gpu.py``).
"""

import contextlib

import pytest
import torch

from grid_tpu_torch.ops import gpu_select
from grid_tpu_torch.ops.gpu_kernels import _r_pad


@pytest.mark.parametrize("r", [1, 15, 16, 17, 130, 1000, 2048])
def test_bfloat16_r_pad_is_one_k16_step(r):
    """P's bf16 rows are padded to a multiple of 16 (one k16 step; the
    TMA boxes' 64 columns read zeros past it), never to the stage."""
    pad = _r_pad(r, torch.bfloat16)
    assert pad % 16 == 0 and r <= pad < r + 16


class _FakeSelectLib:
    """Stands in for the dipcn_select library: counts the mode queries and
    answers from a table."""

    def __init__(self, answers):
        self.answers, self.calls = answers, []

    def _query(self, suffix, index, w, k, mode):
        self.calls.append((suffix, index, w, k))
        mode._obj.value = self.answers[w]
        return 0

    def __getattr__(self, name):
        suffix = name.removeprefix("dipcn_select_mode")
        return lambda *args: self._query(suffix, *args)


def test_dipcn_select_mode_is_asked_once_per_width_k_card_and_dtype(monkeypatch):
    """The wrapper asks the card for the mode once per (w, k, card, dtype),
    as knn_select's query is cached: the occupancy queries behind it cost
    the host more than a resident launch."""
    fake = _FakeSelectLib({2504: 0, 65536: 1, 1 << 22: -1})
    monkeypatch.setattr(gpu_select, "_lib", lambda: fake)
    monkeypatch.setattr(gpu_select.torch.cuda, "device", lambda index: contextlib.nullcontext())
    gpu_select._dipcn_mode_on.cache_clear()
    try:
        card0, card1 = torch.device("cuda", 0), torch.device("cuda", 1)
        for _ in range(3):
            assert gpu_select.dipcn_select_mode(2504, 500, card0) == "resident"
            assert gpu_select.dipcn_select_mode(65536, 500, card0, torch.bfloat16) == "wide"
        assert fake.calls == [("", 0, 2504, 500), ("_bf16", 0, 65536, 500)]
        assert gpu_select.dipcn_select_mode(2504, 500, card0, torch.float64) == "resident"
        assert gpu_select.dipcn_select_mode(2504, 300, card0) == "resident"
        assert gpu_select.dipcn_select_mode(2504, 500, card1) == "resident"
        assert gpu_select.dipcn_select_mode(1 << 22, 500, card0) is None
        assert gpu_select.dipcn_select_mode(1 << 22, 500, card0) is None
        assert fake.calls[2:] == [("_f64", 0, 2504, 500), ("", 0, 2504, 300),
                                  ("", 1, 2504, 500), ("", 0, 1 << 22, 500)]
    finally:
        gpu_select._dipcn_mode_on.cache_clear()
