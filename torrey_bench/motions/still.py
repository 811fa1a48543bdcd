"""A still camera: the user holds the view, and the accumulation runs on."""


def before_frame(renderer, frame, rng):
    """Move ``renderer``'s camera (``set_camera``) before timed frame
    ``frame``, drawing from ``rng`` (a ``random.Random`` of the run's
    seed), or leave it: here, leave it."""
