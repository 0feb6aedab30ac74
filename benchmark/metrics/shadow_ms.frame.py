"""Host milliseconds per frame in DeviceInstancer._shadow_blocked_sparse
(the shadow query), each call between two synchronisations, over the
traced run's synchronised frames; nothing where no ray casts shadows."""


def read(trace):
    if trace.get("kind") != "session" or not trace["part3"]["seconds"].get("shadow"):
        return None
    p = trace["part3"]
    return p["seconds"]["shadow"] / p["units"] * 1e3
