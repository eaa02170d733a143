"""The output check catches a broken training program: each fault a
training cell can have is planted underneath a CPU run of ``adult.train``
at a small size (the look for a card skipped), and ``correct`` must come
out false: a round that leaves the clients' state unchanged; each step on
half of its batch (the means over the rest); the merge left out (the
clients' exchange); an encoded entry altered where the encode makes it.
The faults in the rounds share one program set-up (as copies); the
encode's fault makes its own."""
import pytest
import torch

from _small import run_small


def _unchanged(monkeypatch):
    from repro_torch.fed.program import FederatedProgram
    orig = FederatedProgram.global_round

    def frozen(self, states, *a, **k):
        saved = [[t.detach().clone() for t in s.params()] for s in states]
        out = orig(self, states, *a, **k)
        with torch.no_grad():
            for s, kept in zip(states, saved):
                for t, v in zip(s.params(), kept):
                    t.copy_(v)
        return out
    monkeypatch.setattr(FederatedProgram, "global_round", frozen)


def _half_batch(monkeypatch):
    from repro_torch.synth import engine
    orig = engine.make_train_steps

    def make(cfg, spans, cond_spans):
        step = orig(cfg, spans, cond_spans)

        def half(state, batch, noise=None):
            h = batch[0].shape[0] // 2
            hp = h // cfg.pac
            noise = noise._replace(
                z_d=noise.z_d[:h], u_d=noise.u_d[:h], z_g=noise.z_g[:h],
                u_g=noise.u_g[:h], gp_eps=noise.gp_eps[:hp],
                keep_d_fake=[k[:hp] for k in noise.keep_d_fake],
                keep_d_real=[k[:hp] for k in noise.keep_d_real],
                keep_g=[k[:hp] for k in noise.keep_g])
            return step(state, tuple(t[:h] for t in batch), noise)
        return half
    monkeypatch.setattr(engine, "make_train_steps", make)


def _no_merge(monkeypatch):
    from repro_torch.fed import program
    monkeypatch.setattr(program.FederatedProgram, "_merge",
                        lambda self, states, w: program.flatten_stacked(
                            [s.params() for s in states]))


def _encode_altered(monkeypatch):
    from repro_torch.tabular.encoders import EncodePlan
    orig = EncodePlan.encode

    def encode(self, *a, **k):
        out = orig(self, *a, **k)
        out[0, 0] += 0.25
        return out
    monkeypatch.setattr(EncodePlan, "encode", encode)


FAULTS = [_unchanged, _half_batch, _no_merge, _encode_altered]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_fault_reads_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    res = run_small("adult.train",
                    program_setup=fault is not _encode_altered)
    assert not res["correct"], res["compared"]
