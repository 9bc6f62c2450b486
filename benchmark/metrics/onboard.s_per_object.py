"""onboard.s_per_object: host seconds of onboarding (`pipeline/
templates.py:onboard_templates`, from host RGBA renders to the feature
store) per object, timed in set-up by the driver from a synchronize to a
synchronize. Moves setup_s."""


def read(tr, driver):
    c = driver.counters
    if not c.get("objects"):
        return None
    return c["onboard_s"] / c["objects"]
