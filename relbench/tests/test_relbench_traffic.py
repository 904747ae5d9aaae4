"""The frozen traffic generator: determinism, Table 4's prompt lengths,
the decks, and rows that fit their configuration."""
import json
import statistics
from pathlib import Path

import pytest

from relbench.traffic import gen

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def _mix(name):
    return json.loads((ROOT / "relbench" / "traffic" / f"{name}.json").read_text())


def _dump(specs):
    return json.dumps([[s.rel_id, s.dataset, s.qtype, s.prompts,
                        s.max_output_tokens, s.due] for s in specs])


@pytest.mark.parametrize("mix", ["relq_poisson", "relq_bulk_gen", "relq_bulk_short"])
def test_same_seed_same_relqueries(mix):
    m = _mix(mix)
    a = gen.build(m, 2 ** 31 + 17, 51)
    assert _dump(a) == _dump(gen.build(m, 2 ** 31 + 17, 51))
    assert _dump(a) != _dump(gen.build(m, 2 ** 31 + 18, 51))


@pytest.mark.parametrize("mix", ["relq_poisson", "relq_bulk_gen", "relq_bulk_short"])
def test_every_seed_gets_the_same_deck(mix):
    """Shapes, output limits and due times are the mix's; the seed draws
    only the rows' text."""
    m = _mix(mix)
    shape = lambda specs: [(s.dataset, s.qtype, len(s.prompts), s.max_output_tokens,
                            s.due) for s in specs]
    assert shape(gen.build(m, 1, 51)) == shape(gen.build(m, 99, 51))


def test_open_loop_window_holds_rate_times_seconds():
    m = _mix("relq_poisson")
    specs = gen.build(m, 5, 51)
    inside = [s for s in specs if s.due < 51]
    assert len(inside) == round(m["rate_relq_per_s"] * 51)
    assert all(51 <= s.due < 51 + m["drain_s"] for s in specs[len(inside):])
    assert [s.due for s in specs] == sorted(s.due for s in specs)


@pytest.mark.parametrize("dataset", list(gen.DATASET_STATS))
def test_prompt_means_match_table_4(dataset):
    """A template that renders both the item and the review comes within
    half a standard deviation of its rows' lengths (the generator's own
    spread) of Table 4's average prompt length."""
    avg, _ = gen.DATASET_STATS[dataset]
    tok = gen.HashTokenizer()
    tpl = gen.default_templates(dataset)["rating"]
    lens = [len(tok.encode(tpl.render(r)))
            for r in gen.make_table(dataset, 400, seed=3)]
    sd = statistics.pstdev(lens)
    assert abs(statistics.fmean(lens) - avg) <= sd / 2, (statistics.fmean(lens), avg, sd)


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_rows_fit_their_configuration(cell):
    cfg = next(c for c in MANIFEST["configs"] if c["name"] == cell["config"])
    max_len = json.loads((ROOT / cfg["file"]).read_text())["serving"]["max_len"]
    m = _mix(cell["traffic"])
    for seed in (0, 1, 2 ** 31 + 5):
        specs = gen.build(m, seed, MANIFEST["run_seconds"]) + gen.build(
            m, seed, MANIFEST["run_seconds"], stream="warmup",
            count=m["warmup_relqueries"])
        assert max(len(p) + s.max_output_tokens
                   for s in specs for p in s.prompts) <= max_len


def test_relqueries_never_share_whole_rows():
    """Each relQuery reads its own rows: value overlap comes from shared
    item descriptions, not repeated rows."""
    m = _mix("relq_bulk_gen")
    seen = set()
    for s in gen.build(m, 3, 51):
        ids = {tuple(p) for p in s.prompts}
        if s.qtype == "summarize":        # the review comes first: all unique
            assert not ids & seen
            seen |= ids
