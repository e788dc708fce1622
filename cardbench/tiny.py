"""Sizes at which the CPU tests drive a whole run (harness.run_cell with
device="cpu"): every configuration cut to a few dozen rows, its ranks
kept, every traffic mix to 6 outer iterations and at most 3 starts, all
of them checked."""

CFG = {
    "fusion": {"sizes": {"samples": 12, "components": 6, "eem": [12, 10, 8],
                         "eem_rank": 3, "nmr": [12, 9, 7], "nmr_rank": 5,
                         "lcms": [12, 11], "lcms_rank": 5, "noise": 0.03}},
}


def overrides(cell):
    """(cfg_override, traffic_override) of a cell at the test size."""
    from cardbench.harness import find_cell, load_json, HERE
    _, w = find_cell(cell)
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    starts = min(traffic["n_starts"], 3)
    return CFG[w["config"]], {"max_outer_iters": 6, "n_starts": starts,
                              "check_starts": starts}
