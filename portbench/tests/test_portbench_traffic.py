"""The generator: the same seed gives the same requests, lengths stay in
their clips, and every seed gets the same sizes and gaps in another
order."""
import pytest

from traffic import generate as G

MIXES = ["rag", "docqa-batch", "merge"]


def key(specs):
    return [(s.rid, s.prompt_len, s.out_len, s.due, s.image, s.cls)
            for s in specs]


def make(mix, seed):
    m = G.load(mix)
    if m["kind"] == "open_poisson":
        return m, G.open_loop(m, seed, 30.0)
    return m, G.closed_loop(m, seed)


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_requests(mix):
    assert key(make(mix, 4_000_000_001)[1]) == key(make(mix, 4_000_000_001)[1])
    assert G.prompt_tokens(2**33 + 5, 7, 50, 1000) == \
        G.prompt_tokens(2**33 + 5, 7, 50, 1000)


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_inside_their_clips(mix):
    m, specs = make(mix, 123)
    for s in specs:
        cl = m["classes"][s.cls]
        assert cl["prompt"]["min"] <= s.prompt_len <= cl["prompt"]["max"]
        assert cl["output"]["min"] <= s.out_len <= cl["output"]["max"]
        if s.due is not None:
            assert 0.0 <= s.due < 30.0


@pytest.mark.parametrize("mix", MIXES)
def test_seeds_share_one_population(mix):
    """Every seed gets the same sizes and gaps: in another order, or in
    the same where the mix fixes its order."""
    m, a = make(mix, 1)
    _, b = make(mix, 2**40 + 3)
    fixed = m.get("order") == "fixed"
    assert (key(a) == key(b)) == fixed
    assert sorted((s.prompt_len, s.out_len) for s in a) == \
        sorted((s.prompt_len, s.out_len) for s in b)
    if a[0].due is not None:
        gaps = lambda xs: sorted(round(y - x, 9) for x, y in zip(
            [0.0] + [s.due for s in xs], [s.due for s in xs]))
        assert len(a) == len(b) == round(m["rate_req_s"] * 30)
        # the same gaps, reordered (the last, to the close, is left out)
        assert len(set(gaps(a)) & set(gaps(b))) >= len(a) - 2
    assert G.prompt_tokens(1, 3, 20, 1000) != \
        G.prompt_tokens(2**40 + 3, 3, 20, 1000)


def test_merge_mix_has_its_long_share():
    m, specs = make("merge", 9)
    long = [s for s in specs if s.cls == 1]
    assert len(long) == round(0.1 * len(specs))
    assert all(9000 <= s.prompt_len <= 15000 for s in long)
