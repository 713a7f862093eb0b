"""The program's fit phases (PhaseTimer ``hparam_proxy_lbfgs``,
``hparam_grid``, ``hparam_scipy``), in ms per detection."""


def read(rec):
    total = sum(v for k, v in rec.phases.items() if k.startswith("hparam_"))
    n = len(rec.detections)
    return total * 1e3 / n if n and total else None
