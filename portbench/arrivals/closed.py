"""Full batches of `batch`, back to back: the mix's `max_requests`
requests, with no due times."""


def schedule(mix: dict, seed: int, seconds: float):
    return mix["max_requests"], mix["arrivals"]["batch"], None
