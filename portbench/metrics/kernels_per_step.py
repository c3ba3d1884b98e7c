"""Device kernels a training step: the traced window's kernels (copies and
sets left out) over the steps its calls ran."""


def read(r):
    if r.summary is None or not r.counted.get("steps"):
        return None
    kernels = sum(c for name, (_, c) in r.summary["device_ops"].items()
                  if not name.startswith(("Memcpy", "Memset")))
    return kernels / r.counted["steps"]
