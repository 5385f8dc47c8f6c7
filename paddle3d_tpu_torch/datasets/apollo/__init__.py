from .apollo_lane import ApolloLaneDataset, ApolloLaneMetric
