"""Model registry (counterpart of nero_tpu/models/__init__.py)."""


def get_model(name: str):
    if name == "shape":
        from nero_tpu_torch.models.shape import NeROShapeModel
        return NeROShapeModel
    if name == "material":
        from nero_tpu_torch.models.material import NeROMaterialModel
        return NeROMaterialModel
    raise NotImplementedError(f"model {name!r} is not ported yet")
