"""Skin-list rebuilds per 1,000 MD steps over the window
(``MDEngine.run``'s ``n_rebuilds``)."""


def read(outcome):
    c = outcome.counters
    if not c.get("units"):
        return None
    return 1000.0 * c["rebuilds"] / c["units"]
