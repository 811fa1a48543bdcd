"""The host scene build: parse, subdivision, pack and the host-side set
(BVH, or SAH treelets and bricks); the benchmark's span around those calls
into io/ and models/."""


def read(run):
    return run["spans"]["scene_build_s"]
