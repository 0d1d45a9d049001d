"""What the port's benchmark scripts share: one CSV row per measurement."""


def emit(name: str, us_per_call: float, derived: str = ""):
    print(f"{name},{us_per_call:.2f},{derived}", flush=True)
