"""Milliseconds per request in RenderSession.render outside the renderer
call (pose, device rays, the proxy test, read-back and straight alpha),
each between two synchronisations, over the traced run's synchronised
requests."""


def read(trace):
    if trace.get("kind") != "session":
        return None
    p = trace["part3"]
    return (p["seconds"]["session"] - p["seconds"]["renderer"]) / p["units"] * 1e3
