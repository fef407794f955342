// betabridge: host-side C++ UDP bridge speaking the Betaflight SITL wire
// protocol used by the reference's BetaAviary (BetaAviary.py:97-170):
//
//   out -> 9003 + 10*i : FDM packet, 18 native doubles
//          [t, gyro_rpy(3) (ENU->NED sign flips on y,z), lin_acc(3),
//           quat_wxyz(4), vel(3), pos(3), pressure]
//   out -> 9004 + 10*i : RC packet, 1 double + 16 uint16 channels
//   in  <- 9002 + 10*i : servo packet, 4 floats (motor PWM fractions 0..1)
//
// The PWM receive socket is non-blocking; on a miss the previous action is
// kept (BetaAviary.py:161-170 keeps the stale action on socket.error).
// Exposed through a C ABI for ctypes.

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

constexpr int kBasePortPwm = 9002;    // in (we bind)
constexpr int kBasePortState = 9003;  // out
constexpr int kBasePortRc = 9004;     // out

struct Channel {
  int send_fd = -1;
  int pwm_fd = -1;
  sockaddr_in state_addr{};
  sockaddr_in rc_addr{};
  float last_pwm[4] = {0, 0, 0, 0};
};

#pragma pack(push, 1)
struct FdmPacket {
  double timestamp;
  double imu_angular_velocity_rpy[3];
  double imu_linear_acceleration_xyz[3];
  double imu_orientation_quat[4];  // w, x, y, z
  double velocity_xyz[3];
  double position_xyz[3];
  double pressure;
};
struct RcPacket {
  double timestamp;
  uint16_t channels[16];
};
#pragma pack(pop)
static_assert(sizeof(FdmPacket) == 18 * 8, "fdm packet layout");
static_assert(sizeof(RcPacket) == 8 + 32, "rc packet layout");

sockaddr_in make_addr(const char* ip, int port) {
  sockaddr_in a{};
  a.sin_family = AF_INET;
  a.sin_port = htons(static_cast<uint16_t>(port));
  inet_pton(AF_INET, ip, &a.sin_addr);
  return a;
}

}  // namespace

extern "C" {

void* bb_create(const char* ip, int drone_index) {
  auto* ch = new Channel();
  ch->send_fd = socket(AF_INET, SOCK_DGRAM, 0);
  ch->pwm_fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (ch->send_fd < 0 || ch->pwm_fd < 0) { delete ch; return nullptr; }
  ch->state_addr = make_addr(ip, kBasePortState + 10 * drone_index);
  ch->rc_addr = make_addr(ip, kBasePortRc + 10 * drone_index);
  sockaddr_in bind_addr = make_addr(ip, kBasePortPwm + 10 * drone_index);
  int one = 1;
  setsockopt(ch->pwm_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  if (bind(ch->pwm_fd, reinterpret_cast<sockaddr*>(&bind_addr),
           sizeof(bind_addr)) != 0) {
    close(ch->send_fd); close(ch->pwm_fd); delete ch; return nullptr;
  }
  fcntl(ch->pwm_fd, F_SETFL, O_NONBLOCK);
  return ch;
}

void bb_destroy(void* handle) {
  auto* ch = static_cast<Channel*>(handle);
  if (!ch) return;
  close(ch->send_fd);
  close(ch->pwm_fd);
  delete ch;
}

// gyro_body is the ENU body-frame angular velocity (rad/s); the protocol's
// ENU->NED conversion (sign flips on y, z — BetaAviary.py:129-131) happens
// here. The reference zeroes acc/quat/vel/pos in the FDM packet (:132-136);
// full-state variants are still accepted for forward compatibility.
int bb_send_fdm(void* handle, double t, const double* gyro_body,
                const double* lin_acc, const double* quat_wxyz,
                const double* vel, const double* pos, double pressure) {
  auto* ch = static_cast<Channel*>(handle);
  FdmPacket p{};
  p.timestamp = t;
  p.imu_angular_velocity_rpy[0] = gyro_body[0];
  p.imu_angular_velocity_rpy[1] = -gyro_body[1];
  p.imu_angular_velocity_rpy[2] = -gyro_body[2];
  for (int k = 0; k < 3; ++k) p.imu_linear_acceleration_xyz[k] = lin_acc[k];
  for (int k = 0; k < 4; ++k) p.imu_orientation_quat[k] = quat_wxyz[k];
  for (int k = 0; k < 3; ++k) p.velocity_xyz[k] = vel[k];
  for (int k = 0; k < 3; ++k) p.position_xyz[k] = pos[k];
  p.pressure = pressure;
  const ssize_t n = sendto(ch->send_fd, &p, sizeof(p), 0,
                           reinterpret_cast<sockaddr*>(&ch->state_addr),
                           sizeof(ch->state_addr));
  return n == sizeof(p) ? 0 : -1;
}

int bb_send_rc(void* handle, double t, const uint16_t* channels16) {
  auto* ch = static_cast<Channel*>(handle);
  RcPacket p{};
  p.timestamp = t;
  std::memcpy(p.channels, channels16, sizeof(p.channels));
  const ssize_t n = sendto(ch->send_fd, &p, sizeof(p), 0,
                           reinterpret_cast<sockaddr*>(&ch->rc_addr),
                           sizeof(ch->rc_addr));
  return n == sizeof(p) ? 0 : -1;
}

// Drains the PWM socket; returns 1 if a fresh packet was read, 0 if the
// previous (stale) action is returned, matching the reference's stale-action
// policy on socket timeouts.
int bb_recv_pwm(void* handle, float* out4) {
  auto* ch = static_cast<Channel*>(handle);
  float buf[4];
  int fresh = 0;
  for (;;) {
    const ssize_t n = recv(ch->pwm_fd, buf, sizeof(buf), 0);
    if (n == sizeof(buf)) {
      std::memcpy(ch->last_pwm, buf, sizeof(buf));
      fresh = 1;
      continue;  // keep draining to the most recent packet
    }
    break;
  }
  std::memcpy(out4, ch->last_pwm, sizeof(ch->last_pwm));
  return fresh;
}

}  // extern "C"
