"""Cells cut to a size a CPU test run holds: a 16x16x1 image, the sf-0.1
U-Net's widths, a few samples and steps, float32 compute unless asked."""

from h100_bench import harness


def tiny_cell(name: str, root: str = harness.ROOT, dtype: str = "float32") -> harness.Cell:
    cell = harness.find_cell(harness.manifest(root), name, root)
    cell.config = dict(cell.config, image_size=16, channels=1, compute_dtype=dtype,
                       dataset_size=48, batch_size=8, timesteps=6, student_size_factors=[0.1])
    tr = dict(cell.traffic)
    if tr["driver"] == "sweep":
        tr.update(num_samples=4, timesteps=5, guidance_scales=[1.0, 3.0, 5.0],
                  check={"scales_always": [1.0, 5.0], "scales_drawn": 1})
    elif tr["driver"] == "pairs":
        tr.update(timesteps=5, student_size_factor=0.1, traced_calls=2, check={"calls": 2})
    cell.traffic = tr
    return cell
