"""``repro_torch.benchmarks.kernel_variants`` on the CPU: every variant's
text replacements still apply to the CUDA sources (each replaced text
occurs exactly once), and ``main`` refuses to run without a card. The
variants themselves compile and run only on the card."""
from __future__ import annotations

import pytest
import torch

from repro_torch.benchmarks import kernel_variants as kv

CASES = [(k, n) for k in kv.VARIANTS for n in kv.VARIANTS[k]]


@pytest.mark.parametrize("kernel, name", CASES)
def test_variant_applies_to_its_source(kernel, name):
    sources = kv.variant_sources(kernel)
    text, keeps = sources[name]
    final = sources["final"][0]
    assert (text == final) == (name == "final")
    assert keeps == kv.VARIANTS[kernel][name][1]
    for _, new in kv.VARIANTS[kernel][name][0]:
        assert new in text


def test_parent_sources_join_as_a_variant(tmp_path):
    for stem in kv.STEM.values():
        (tmp_path / f"{stem}.cu").write_text(f"// {stem}\n")
    for kernel, stem in kv.STEM.items():
        assert kv.variant_sources(kernel, tmp_path)["parent"] == (
            f"// {stem}\n", True)


def test_a_stale_replacement_raises(monkeypatch):
    monkeypatch.setitem(kv.VARIANTS["gemm_bf16"], "stale",
                        ([("no such text", "x")], True))
    with pytest.raises(ValueError, match="occurs 0 times"):
        kv.variant_sources("gemm_bf16")


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kv.main()
