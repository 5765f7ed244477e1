"""session.host_ms_per_image: an evaluate_image call's wall less its
BatchScorer.score_batch wall (the session's staging, callbacks and report),
mean over the window's calls, ms."""


def read(run):
    calls = [c for c in run.ok_calls if "score_batch" in c.spans]
    if not calls:
        return None
    return sum((c.t1 - c.t0) - c.spans["score_batch"] for c in calls) * 1e3 / len(calls)
