"""The device scene: ``ProgressiveRenderer`` built from the host-side set
(upload, walk table, camera, accumulation buffer), synced; the
benchmark's span around it."""


def read(run):
    return run["spans"]["scene_upload_s"]
