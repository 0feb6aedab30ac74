"""Host milliseconds per frame in DeviceInstancer._per_ray (culls, slab
tests, top-K, event walk, shadow pass), each call between two
synchronisations, over the traced run's synchronised frames."""


def read(trace):
    if trace.get("kind") != "session":
        return None
    p = trace["part3"]
    return p["seconds"]["per_ray"] / p["units"] * 1e3
