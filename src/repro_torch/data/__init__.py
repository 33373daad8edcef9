from .synthetic import PlantedCoClusters, planted_cocluster_matrix

__all__ = ["PlantedCoClusters", "planted_cocluster_matrix"]
