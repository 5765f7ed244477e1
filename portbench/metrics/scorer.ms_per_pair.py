"""scorer.ms_per_pair: BatchScorer.score_batch wall over the candidates it
scored, summed over the window's calls, ms.  The call ends in the scores'
one device-to-host fetch, so it is synchronised."""


def read(run):
    calls = [c for c in run.ok_calls if "score_batch" in c.spans]
    pairs = sum(c.pairs for c in calls)
    return sum(c.spans["score_batch"] for c in calls) * 1e3 / pairs if pairs else None
