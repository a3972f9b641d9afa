"""loop_keyframes: the keyframes the loop service had processed at the
window's close (``Records.outputs["loop_service"]``)."""


def read(rec):
    service = rec.outputs.get("loop_service")
    return None if service is None else service["keyframes"]
