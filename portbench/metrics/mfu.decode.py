"""mfu.decode: the whole window's share of one H100's peaks, in %: the least
time the published peaks allow for every call and step of the window
(`roofline.least_seconds`, counted from the configuration's shapes) over
the window's host seconds. Read in cells whose window runs the decode
driver and whose reference describes the model's shapes; nothing
elsewhere."""


def read(ctx):
    win = ctx["window"]
    ran = any(w["kind"] == "decode" and (w.get("count") or w.get("positions"))
              for w in win.get("work", []))
    if ctx["least_s"] is None or not ran:
        return None
    return 100.0 * ctx["least_s"] / win["seconds"]
