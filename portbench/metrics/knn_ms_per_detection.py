"""The program's ``knn_search`` phase (PhaseTimer), in ms per detection."""


def read(rec):
    n = len(rec.detections)
    return rec.phases["knn_search"] * 1e3 / n if n and "knn_search" in rec.phases else None
