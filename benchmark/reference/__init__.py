"""The plain reference of a Stage-I training step, in float32 (TF32 off).

A frozen copy of the arithmetic of nero_tpu_torch's plain path (NeuS SDF
with geometric init, NeRF++ background, the split-sum shader of NeRO, the
occlusion loss, Adam with the warm-up-cosine schedule), written with plain
torch operations. It imports nothing of the program: it works out again
everything the program derives from the inputs (rays, lattices, encodings,
the FG lookup table) and replays the program's random draws from the same
generator state, draw for draw.
"""
