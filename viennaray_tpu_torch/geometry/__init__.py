"""viennaray_tpu_torch.geometry"""
