"""A run with the timed path broken underneath comes out not correct: the
harness drives the rest of a run (on the CPU, the card's look skipped by
--device cpu), once a fault this cell can have.  One card: no exchange
between chips to leave out."""

import pytest

from cfr_bench.tests.tiny import make_root, run


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("checkout")))


def stale_state(monkeypatch):
    """Every batch gets the results of the first (the warm-up's)."""
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    orig, kept = ClassifierTorch.finish_packed, []

    def finish_packed(self, ctx):
        packed, fb = orig(self, ctx)
        if not kept:
            kept.append((packed.copy(), dict(fb)))
        p0, fb0 = kept[0]
        n = min(len(p0), len(packed))
        packed = packed.copy()
        packed[:n] = p0[:n]
        return packed, {k: v for k, v in fb0.items() if k < len(packed)}
    monkeypatch.setattr(ClassifierTorch, "finish_packed", finish_packed)


def half_batch(monkeypatch):
    """Half of each batch left out of what is written."""
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    orig = ClassifierTorch.format_tsv_batch

    def format_tsv_batch(self, packed, fb, queries, read_ids):
        h = len(queries) // 2
        return orig(self, None if packed is None else packed[:h],
                    {k: v for k, v in fb.items() if k < h}, queries[:h], read_ids[:h])
    monkeypatch.setattr(ClassifierTorch, "format_tsv_batch", format_tsv_batch)


def altered_answer(monkeypatch):
    """Every 16th read's score one higher, where the device produces it."""
    from centrifuger_tpu_torch.classify.engine import ClassifierTorch
    orig = ClassifierTorch.finish_packed

    def finish_packed(self, ctx):
        packed, fb = orig(self, ctx)
        packed = packed.copy()
        packed[::16, 0] += 1
        return packed, fb
    monkeypatch.setattr(ClassifierTorch, "finish_packed", finish_packed)


@pytest.mark.parametrize("fault", [stale_state, half_batch, altered_answer])
def test_fault_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    rc, res = run(root, "tiny-nt.tpe", 4242)
    assert rc == 0 and res["correct"] is False
    assert max(v["value"] for v in res["checks"].values()) > 0
