"""viennaray_tpu_torch.trace"""
