"""fastme_passes_per_inter_frame: the program's count of fast-ME chain passes
(``pkg["fast_me_passes"]``, one ``rowscan_pass`` launch each) per inter frame,
over the window's segments."""


def read(run):
    passes = run["window"]["counters"].get("fast_me_passes", [])
    return sum(passes) / len(passes) if passes else None
