"""Share (%) of the window the served loop spent in the clock's
sleep_until, waiting out modeled slot lengths and arrivals."""


def read(run):
    return 100.0 * run.slept_s / run.window_s
