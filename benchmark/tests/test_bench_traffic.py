"""The traffic generator: the same seed gives the same songs, every seed the
same sizes, and the sizes follow the mixes' stated distributions."""

import math

import numpy as np
import pytest

from benchmark import generator
from benchmark.reference import preprocess as pp

TS = 512 / 44100
MIXES = ("render_songs", "score_songs")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_songs(name):
    mix = generator.load_mix(name)
    assert generator.songs(mix, 2**31 + 5, TS) == generator.songs(mix, 2**31 + 5, TS)


@pytest.mark.parametrize("name", MIXES)
def test_seeds_share_sizes_not_content(name):
    mix = generator.load_mix(name)
    a, b = generator.songs(mix, 3, TS), generator.songs(mix, -(2**40) + 1, TS)
    assert a != b
    for sa, sb in zip(a, b):
        assert sorted(generator.frames(p, TS) for p in sa) == sorted(
            generator.frames(p, TS) for p in sb)


@pytest.mark.parametrize("name", MIXES)
def test_planned_distributions(name):
    mix = generator.load_mix(name)
    plan = generator.plan(mix, TS)
    lo, hi = mix["phrases_per_song"]
    assert all(lo <= len(song) <= hi for song in plan)
    seconds = np.array([p["frames"] * TS for song in plan for p in song])
    assert seconds.min() >= mix["phrase_seconds"][0] - TS
    assert seconds.max() <= mix["phrase_seconds"][1] + TS
    # log-uniform: the median near the geometric mean of the range
    assert abs(math.log(np.median(seconds)) - np.mean(np.log(mix["phrase_seconds"]))) < 0.2
    rate = np.array([p["phonemes"] / (p["frames"] * TS) for song in plan for p in song])
    assert rate.min() >= mix["phonemes_per_second"][0] - 0.5
    assert rate.max() <= mix["phonemes_per_second"][1] + 0.5


@pytest.mark.parametrize("name", MIXES)
def test_phrases_are_what_the_plan_sized(name):
    """The servers' own rounding of the durations gives the planned frames,
    and each phrase has about its planned phonemes, all in the dictionary."""
    mix = generator.load_mix(name)
    plan = generator.plan(mix, TS)
    ids = pp.phoneme_ids(generator.DICTIONARY)
    for song, sizes in zip(generator.songs(mix, 17, TS)[:3], plan[:3]):
        assert sorted(generator.frames(p, TS) for p in song) == sorted(s["frames"] for s in sizes)
        for seg in song:
            phones = seg["ph_seq"].split()
            assert all(p in ids for p in phones)
            assert sum(map(int, seg["ph_num"].split())) == len(phones)
            n_notes = len(seg["note_seq"].split())
            assert len(seg["note_dur"].split()) == len(seg["note_slur"].split()) == n_notes
            if mix["kind"] == "render":
                arrays = pp.acoustic_arrays(seg, ids, TS)
                assert len(arrays["mel2ph"]) == generator.frames(seg, TS)
                assert (arrays["f0"] > 0).all()
            else:
                arrays = pp.variance_arrays(seg, ids, TS, 5)
                assert len(arrays["base_pitch"]) == generator.frames(seg, TS)
        n_ph = sorted(len(seg["ph_seq"].split()) for seg in song)
        planned = sorted(s["phonemes"] for s in sizes)
        assert all(abs(a - b) <= 2 for a, b in zip(n_ph, planned))


def test_training_store_from_the_seed():
    """The store's items: the same seed gives the same items, every seed the
    same sizes, and the sizes follow the mix's distribution."""
    mix = dict(generator.load_mix("train_store"), items=12)
    a, b = generator.store_items(mix, 2**31 + 5, TS, 8), generator.store_items(mix, 2**31 + 5, TS, 8)
    c = generator.store_items(mix, -(2**40) + 1, TS, 8)
    assert all(x["seg"] == y["seg"] and np.array_equal(x["mel"], y["mel"]) for x, y in zip(a, b))
    assert [len(x["mel"]) for x in a] == [len(x["mel"]) for x in c] and a[0]["seg"] != c[0]["seg"]
    full = generator.load_mix("train_store")
    seconds = np.array([s["frames"] * TS for s in generator.store_sizes(full, TS)])
    lo, hi = full["phrase_seconds"]
    assert len(seconds) == full["items"] and lo - TS <= seconds.min() <= seconds.max() <= hi + TS
    assert abs(math.log(np.median(seconds)) - np.mean(np.log(full["phrase_seconds"]))) < 0.1
