"""A run whose timed path is broken underneath comes out not correct: a
decode step that leaves the cache unchanged, half of the decode batch left
out (each odd lane given its even neighbour's result), a token altered where it is
produced. (One card: no exchange between chips to leave out.)"""
import pytest

from bench.tests._cells import run_reduced


def _altered_token(monkeypatch):
    from repro_torch.serving import executable
    forward = executable.DecodeExecutable.forward

    def altered(self):
        forward(self)
        self.next_tok[0] = (self.next_tok[0] + 1) % self.vocab
    monkeypatch.setattr(executable.DecodeExecutable, "forward", altered)


def _state_unchanged(monkeypatch):
    from repro_torch.serving import kvpool
    monkeypatch.setattr(kvpool, "scatter_token", lambda store, *a, **k: store)


def _half_batch(monkeypatch):
    from repro_torch.serving import kvpool
    make = kvpool.make_paged_decode

    def make_half(model, pax, sax):
        full = make(model, pax, sax)

        def half(tokens, store, pos, tables):       # the even lanes alone
            logits, store = full(tokens[0::2], store, pos[0::2], tables[0::2])
            return logits.repeat_interleave(2, dim=0), store
        return half
    monkeypatch.setattr(kvpool, "make_paged_decode", make_half)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged, _half_batch])
@pytest.mark.parametrize("workload", ["qwen-chat-poisson", "minitron-chat-poisson"])
def test_a_broken_path_is_not_correct(monkeypatch, fault, workload):
    fault(monkeypatch)
    res = run_reduced(workload, rate=40.0)         # several lanes decode at once
    assert res["correct"] is False
    assert res["checks"]["mean_logit_gap"]["value"] > res["checks"]["mean_logit_gap"]["limit"]
