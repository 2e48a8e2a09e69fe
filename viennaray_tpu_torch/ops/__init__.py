"""viennaray_tpu_torch.ops"""
