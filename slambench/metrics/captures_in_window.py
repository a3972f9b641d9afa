"""captures_in_window: graph captures the frame program made inside the
replay window (a shape the warm-up did not reach)."""


def read(rec):
    if rec.mode != "replay" or "graph_capture" not in rec.graphs:
        return None
    return rec.graphs["graph_capture"]
