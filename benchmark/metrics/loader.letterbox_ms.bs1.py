"""ms a frame of the program's `loader.letterbox` alone, over PASSES
passes of the cell's frames."""

PASSES = 8


def read(run):
    if not hasattr(run.driver, "letterbox_ms") or run.batch != 1:
        return None
    return run.driver.letterbox_ms(PASSES)
