"""The program's ``embed_*`` phases (PhaseTimer, device-synchronised), in ms
per 1000 pairs embedded."""


def read(rec):
    total = sum(v for k, v in rec.phases.items() if k.startswith("embed_"))
    return total * 1e3 / rec.pairs * 1e3 if rec.pairs and total else None
