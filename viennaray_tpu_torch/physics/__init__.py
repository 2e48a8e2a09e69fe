"""viennaray_tpu_torch.physics"""
