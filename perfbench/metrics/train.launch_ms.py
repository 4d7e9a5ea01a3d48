"""Host milliseconds a step inside the call that launches it
(``Programs.run``: the step's inputs copied, the graph launched), over
the untraced part of the window. Against ``qat_step_ms``: where the two
meet, the host's launch of the step's graph paces the device."""


def read(outcome):
    c = outcome.counters
    units = c.get("untraced", (0.0, 0))[1]
    if not units or "launch_s" not in c:
        return None
    return 1e3 * c["launch_s"] / units
