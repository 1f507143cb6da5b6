// Wire format shared with the Python deploy stack
// (walk_these_ways_tpu_torch/deploy/messages.py + bus.py).
//
// Counterpart of the reference's LCM IDL types
// (reference: go1_gym_deploy/lcm_types/*.lcm) as packed little-endian
// structs, and of the LCM UDP-multicast transport as a minimal framed
// datagram: "WTW1" | u8 channel_len | channel | payload.
#pragma once

#include <arpa/inet.h>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <string>
#include <sys/socket.h>
#include <unistd.h>

namespace wtw {

static const char kMagic[4] = {'W', 'T', 'W', '1'};
static const char *kGroup = "239.255.76.67";
// The bus port; -DWTW_BUS_PORT=<port> builds a bridge on another one (a
// test's own port, so that two loopback runs on one host do not answer
// each other's targets).  The robot's default is the reference's 7667.
#ifndef WTW_BUS_PORT
#define WTW_BUS_PORT 7667
#endif
static const int kPort = WTW_BUS_PORT;

static const char *kChannelLegControl = "leg_control_data";
static const char *kChannelStateEstimator = "state_estimator_data";
static const char *kChannelRcCommand = "rc_command";
static const char *kChannelPdTargets = "pd_plustau_targets";
[[maybe_unused]] static const char *kChannelCamera = "camera_frame";

#pragma pack(push, 1)
struct LegControlData {        // reference leg_control_data_lcmt
  float q[12];
  float qd[12];
  float tau_est[12];
};

struct PdTauTargets {          // reference pd_tau_targets_lcmt
  float q_des[12];
  float qd_des[12];
  float kp[12];
  float kd[12];
  float tau_ff[12];
  int32_t id;
};

struct RcCommand {             // reference rc_command_lcmt
  float left_stick_x, left_stick_y, right_stick_x, right_stick_y, knob;
  int32_t mode, left_upper_switch, left_lower_left_switch,
      right_upper_switch, right_lower_right_switch;
};

struct StateEstimate {         // reference state_estimator_lcmt
  float p[3];
  float vWorld[3];
  float rpy[3];
  float omegaBody[3];
  float quat[4];
  float aBody[3];
  float contact_estimate[4];
};

// Fragment header for onboard camera frames (counterpart of the reference's
// camera_message_lcmt / camera_message_rect_wide; Python side:
// messages.CameraFrame, format "<BBHHHHHxxI").  Followed by <= 32768 image
// bytes (HWC uint8).
struct CameraFrameHeader {
  uint8_t cam_id;      // 1..5 = front, bottom, left, right, rear
  uint8_t channels;
  uint16_t width;
  uint16_t height;
  uint16_t frame_seq;
  uint16_t n_frags;
  uint16_t frag_idx;
  uint8_t pad[2];
  uint32_t frag_off;
};
#pragma pack(pop)

static const size_t kMaxCameraFrag = 32768;

// ---------------------------------------------------------------------------
// UDP multicast pub/sub
// ---------------------------------------------------------------------------

class Bus {
 public:
  explicit Bus(const char *group = kGroup, int port = kPort, int ttl = 0) {
    tx_ = socket(AF_INET, SOCK_DGRAM, 0);
    setsockopt(tx_, IPPROTO_IP, IP_MULTICAST_TTL, &ttl, sizeof(ttl));
    int loop = 1;
    setsockopt(tx_, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof(loop));
    memset(&addr_, 0, sizeof(addr_));
    addr_.sin_family = AF_INET;
    addr_.sin_addr.s_addr = inet_addr(group);
    addr_.sin_port = htons(port);

    rx_ = socket(AF_INET, SOCK_DGRAM, 0);
    int reuse = 1;
    setsockopt(rx_, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
    sockaddr_in local{};
    local.sin_family = AF_INET;
    local.sin_addr.s_addr = htonl(INADDR_ANY);
    local.sin_port = htons(port);
    bind(rx_, (sockaddr *)&local, sizeof(local));
    ip_mreq mreq{};
    mreq.imr_multiaddr.s_addr = inet_addr(group);
    mreq.imr_interface.s_addr = htonl(INADDR_ANY);
    setsockopt(rx_, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq, sizeof(mreq));
    // non-blocking receive for the control loop
    timeval tv{0, 1000};
    setsockopt(rx_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  }

  ~Bus() {
    close(tx_);
    close(rx_);
  }

  void publish(const std::string &channel, const void *payload, size_t n) {
    char pkt[kMaxCameraFrag + sizeof(CameraFrameHeader) + 64];
    size_t clen = channel.size();
    memcpy(pkt, kMagic, 4);
    pkt[4] = (char)clen;
    memcpy(pkt + 5, channel.data(), clen);
    memcpy(pkt + 5 + clen, payload, n);
    sendto(tx_, pkt, 5 + clen + n, 0, (sockaddr *)&addr_, sizeof(addr_));
  }

  // Receive one datagram; returns channel name and fills payload.
  // Empty string on timeout/garbage.
  std::string receive(char *payload, size_t cap, size_t *n_out) {
    char pkt[4096];
    ssize_t n = recv(rx_, pkt, sizeof(pkt), 0);
    if (n < 5 || memcmp(pkt, kMagic, 4) != 0) return "";
    size_t clen = (unsigned char)pkt[4];
    if ((size_t)n < 5 + clen) return "";
    std::string channel(pkt + 5, clen);
    size_t pn = n - 5 - clen;
    if (pn > cap) pn = cap;
    memcpy(payload, pkt + 5 + clen, pn);
    *n_out = pn;
    return channel;
  }

 private:
  int tx_, rx_;
  sockaddr_in addr_;
};

}  // namespace wtw
