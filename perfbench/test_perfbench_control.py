"""The check must come out not correct for its control (the reference in
the program's place one precision lower: TF32 products) and for the faults
a cell can have: half of a batch left out, an answer altered where it is
produced. CPU tests at a tiny size; the control at the cells' own size on
the card (marked gpu)."""
import pytest
import torch

from perfbench import bench, control, tiny

CELLS = [w["name"] for w in bench.default_bench().data["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = control.readings(bench.default_bench(), cell, 2 ** 31 + 5, 40, "cpu",
                         overrides=tiny.OVERRIDES)
    assert not r["correct"]
    gap = r["checks"]["score_gap"]
    assert gap["value"] > gap["at_most"]


def _broken_query(fault):
    from repro_torch.core.query import ResultSet
    from repro_torch.storage import engine
    real = engine.MicroNN.query

    def query(self, queries, spec=None, *, trace=False):
        if fault == "half_batch":
            h = max(1, len(queries) // 2)
            rs = real(self, queries[:h], spec, trace=trace)
            ids = torch.full((len(queries), rs.k), -1, dtype=rs.ids.dtype)
            scores = torch.full((len(queries), rs.k), float("inf"))
            ids[:h], scores[:h] = rs.ids, rs.scores
            return ResultSet(ids=ids, scores=scores, spec=spec)
        rs = real(self, queries, spec, trace=trace)
        ids = rs.ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % self.index.num_live()
        return ResultSet(ids=ids, scores=rs.scores, spec=spec)
    return query


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch,
                                            tmp_path):
    from repro_torch.storage import engine
    assert tiny.run(cell, workdir=tmp_path)["correct"]
    monkeypatch.setattr(engine.MicroNN, "query", _broken_query(fault))
    r = tiny.run(cell, workdir=tmp_path)
    assert not r["correct"], r["checks"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell, cuda):
    """At the cell's own size, three seeds, as many calls as a short run."""
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = control.readings(bench.default_bench(), cell, seed, 2000, cuda)
        assert not r["correct"], r
        torch.cuda.empty_cache()
