"""The output check catches a broken serving program: each fault a
serving cell can have is planted underneath a CPU run of the cell at a
small size (the look for a card skipped), and ``correct`` must come out
false: an answer altered where the decode makes it; each request's
generator run on half of its bucket, the rest repeated."""
import pytest
import torch

from _small import run_small


def _answer_altered(monkeypatch):
    from repro_torch.tabular.encoders import DecodePlan
    orig = DecodePlan.decode

    def decode(self, encoded):
        out = orig(self, encoded)
        out[:, -1] += 1.0
        return out
    monkeypatch.setattr(DecodePlan, "decode", decode)


def _half_bucket(monkeypatch):
    from repro_torch.serve import server

    def halve(fn, at):          # ``at``: the position of the row count
        def run(*a, **k):
            a = list(a)
            n, a[at] = a[at], a[at] // 2
            out = fn(*a, **k)
            return torch.cat([out, out])[:n]
        return run
    monkeypatch.setattr(server, "sample_synthetic",
                        halve(server.sample_synthetic, 4))
    monkeypatch.setattr(server, "sample_synthetic_conditional",
                        halve(server.sample_synthetic_conditional, 5))


FAULTS = [_answer_altered, _half_bucket]
CASES = [(c, f) for c in ("adult.serve", "intrusion.bulk") for f in FAULTS]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in CASES])
def test_fault_reads_incorrect(monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run_small(cell)
    assert not res["correct"], res["compared"]
