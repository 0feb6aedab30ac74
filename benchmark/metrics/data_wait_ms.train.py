"""Host milliseconds per step that the loop waits for the next batch of
the dataset's prefetch thread (TFRecord decode, Proxy pixel sampler, ray
sampler), over the traced run's unprofiled, free-running steps."""


def read(trace):
    if trace.get("kind") != "train":
        return None
    p = trace["part1"]
    return p["data_wait_s"] / p["units"] * 1e3
